#!/usr/bin/env python3
"""Time the current ``rglru_scan`` and ``sumsq_rows`` CUDA kernels against
an earlier version of their sources, on one CUDA card, in one process.

Run from the repo root with the earlier sources unpacked under a git-ignored
directory, e.g. those of commit ecd5906 (the first port's designs: one
thread per (b, w) lane for the scan, one block per row for sumsq):

    mkdir -p .archive/before
    git archive ecd5906 src/repro_torch/kernels/csrc \
        | tar -x -C .archive/before
    python3 chip_before_after.py .archive/before/src/repro_torch/kernels/csrc

The earlier ``rglru_scan.cu`` and ``dp_clip_noise.cu`` are built with the
port's nvcc flags into ``kernels/_build/before/`` and called through their
own C entry points (``rgs_rglru_scan(a, x, h0, h, h_last, B, L, W,
stream)``, ``dpcn_sumsq_rows(x, out, R, P, stream)``); the current ones
through the port's wrappers.  At each shape ``chip_smoke.py`` times (the
ssm path's and the rglru detector's scan, the paper config's update), both
are first held to the plain version (the scan bitwise, sumsq at rtol 1e-5),
then timed in turns (earlier, current, current, earlier) by
``chip_smoke.device_ms``, beside ``chip_smoke.launch_floor_ms`` and the
bound.  Prints the card and one JSON line, and writes
``chiprun_out/before_after.json``.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs


def build_before(csrc: Path, nvcc) -> dict:
    """Build each earlier source into ``kernels/_build/before/``; returns
    ``{name: ctypes.CDLL}`` and prints ptxas' register lines."""
    out_dir = nvcc.BUILD_DIR / "before"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs, procs = {}, {}
    for name in ("rglru_scan", "dp_clip_noise"):
        lib = out_dir / f"lib{name}.so"
        cmd = [nvcc._nvcc(), *nvcc.NVCC_FLAGS, "-o", str(lib),
               str(csrc / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        cs.check(proc.returncode == 0, f"nvcc failed on the earlier "
                 f"{name}.cu:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  before {name}: {line.strip()}")
        libs[name] = ctypes.CDLL(str(lib))
    p, i64 = nvcc.PTR, nvcc.I64
    libs["rglru_scan"].rgs_rglru_scan.argtypes = [p] * 5 + [i64] * 3 + [p]
    libs["dp_clip_noise"].dpcn_sumsq_rows.argtypes = [p, p, i64, i64, p]
    return libs


def turns(before, after) -> dict:
    """Device ms of both versions, timed earlier, current, current,
    earlier."""
    b1, a1, a2, b2 = (cs.device_ms(f) for f in (before, after, after, before))
    return {"before_ms": [b1, b2], "after_ms": [a1, a2]}


def main() -> int:
    import torch
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    from repro_torch.kernels import _nvcc
    from repro_torch.kernels import dp_clip_noise as dpk
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as rgk

    card = cs.card_line()
    print(f"card: {card}")
    libs = build_before(Path(sys.argv[1]), _nvcc)
    _nvcc.build("rglru_scan", "dp_clip_noise")
    gen = torch.Generator().manual_seed(11)
    rows = []

    for case in (cs.RG_PATH, cs.RG_RGLRU):
        b, l, w, with_h0 = case
        a = torch.sigmoid(torch.randn(b, l, w, generator=gen)).cuda()
        x = torch.randn(b, l, w, generator=gen).cuda()
        h0 = torch.randn(b, w, generator=gen).cuda() if with_h0 else None
        h, h_last = torch.empty_like(a), torch.empty(b, w, device="cuda")

        def before():
            _nvcc.raise_on(libs["rglru_scan"].rgs_rglru_scan(
                a.data_ptr(), x.data_ptr(),
                None if h0 is None else h0.data_ptr(), h.data_ptr(),
                h_last.data_ptr(), b, l, w, _nvcc.stream_of(a)), "before")

        before()
        want = ref.rglru_scan_ref(a, x, h0)
        got = rgk.rglru_scan(a, x, h0)
        cs.check(torch.equal(h, want[0]) and torch.equal(h_last, want[1]) and
                 torch.equal(got[0], want[0]) and
                 torch.equal(got[1], want[1]),
                 f"rglru_scan versions differ from the plain one at {case}")
        rows.append({"kernel": "rglru_scan", "shape": [b, l, w],
                     "bound_ms": cs.scan_bound(case)[0],
                     **turns(before, lambda: rgk.rglru_scan(a, x, h0))})

    r, p = cs.SLICE_ROWS, cs.SLICE_P
    x = torch.randn(r, p, generator=gen).cuda()
    out = torch.empty(r, device="cuda")

    def before_sq():
        _nvcc.raise_on(libs["dp_clip_noise"].dpcn_sumsq_rows(
            x.data_ptr(), out.data_ptr(), r, p, _nvcc.stream_of(x)), "before")

    before_sq()
    want = ref.sumsq_rows_ref(x)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=0)
    torch.testing.assert_close(dpk.sumsq_rows(x), want, rtol=1e-5, atol=0)
    rows.append({"kernel": "sumsq_rows", "shape": [r, p],
                 "bound_ms": cs.sumsq_bound(r, p)[0],
                 **turns(before_sq, lambda: dpk.sumsq_rows(x))})

    floor_ms = cs.launch_floor_ms(torch)
    for row in rows:
        print(f"  {row['kernel']} {row['shape']}: before "
              f"{[round(t * 1e3, 3) for t in row['before_ms']]} us, after "
              f"{[round(t * 1e3, 3) for t in row['after_ms']]} us, floor "
              f"{floor_ms * 1e3:.3f} us, bound {row['bound_ms'] * 1e3:.3f} us")
    record = {"card": card, "launch_floor_ms": floor_ms, "rows": rows}
    out_dir = cs.ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "before_after.json").write_text(json.dumps(record, indent=1))
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
