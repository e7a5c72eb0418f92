#!/usr/bin/env python3
"""Time the current CUDA kernels against an earlier version of their
sources, on one CUDA card, in one process.

Run from the repo root with the earlier sources unpacked under a git-ignored
directory, e.g. those of commit d04f402 (``flash_attention``'s per-row
kernel at head dims above 32) or ecd5906 (the first port's scan and sumsq:
one thread per (b, w) lane, one block per row):

    mkdir -p .archive/before
    git archive d04f402 src/repro_torch/kernels/csrc \
        | tar -x -C .archive/before
    python3 chip_before_after.py .archive/before/src/repro_torch/kernels/csrc

The directory may also hold a patched copy of the current sources, to time
a variant of a kernel: for ``flash_attention``'s tensor-core kernel with P
in one bf16 term rather than two,

    cp -r src/repro_torch/kernels/csrc .archive/p1
    sed -i 's/constexpr int kPTerms = 2;/constexpr int kPTerms = 1;/' \
        .archive/p1/flash_attention.cu
    python3 chip_before_after.py .archive/p1

Each earlier source the directory holds (``rglru_scan.cu``,
``dp_clip_noise.cu``, ``flash_attention.cu``, with the headers beside it)
that differs from the current one is built with the port's nvcc flags into
``kernels/_build/before/`` and called through its own C entry point
(``rgs_rglru_scan(a, x, h0, h, h_last, B, L, W, stream)``,
``dpcn_sumsq_rows(x, out, R, P, stream)``, and ``fa_flash_attention``:
d04f402's, which takes rows 64, heads 1, lanes 1 at D > 32, or one with
the current interface, which takes the current launch plan); the current
ones through the port's wrappers.  At each shape ``chip_smoke.py`` times
(the ssm path's and the rglru detector's scan, the paper config's update,
K3 at the LM shapes of ``chip_smoke.LM_FA_CASES``, bf16 causal; d04f402's
K3 at the two prefill shapes only), both are first held to the plain
version (the scan bitwise, sumsq at rtol 1e-5, K3 at 2e-2, its max error
recorded), then timed in turns (earlier, current, current, earlier) by
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
    """Build each earlier source the directory holds into
    ``kernels/_build/before/``; returns ``{name: ctypes.CDLL}`` and prints
    ptxas' register lines."""
    out_dir = nvcc.BUILD_DIR / "before"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs, procs = {}, {}
    for name in ("rglru_scan", "dp_clip_noise", "flash_attention"):
        src = csrc / f"{name}.cu"
        if not src.exists() or \
                src.read_bytes() == (nvcc.CSRC / f"{name}.cu").read_bytes():
            continue  # absent, or the current source itself
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
    p, i64, i32 = nvcc.PTR, nvcc.I64, nvcc.I32
    if "rglru_scan" in libs:
        libs["rglru_scan"].rgs_rglru_scan.argtypes = [p] * 5 + [i64] * 3 + [p]
    if "dp_clip_noise" in libs:
        libs["dp_clip_noise"].dpcn_sumsq_rows.argtypes = [p, p, i64, i64, p]
    if "flash_attention" in libs:
        # d04f402's interface has no kernel code: 9 ints after the scale
        n_ints = 10 if current_fa_abi(csrc) else 9
        libs["flash_attention"].fa_flash_attention.argtypes = (
            [p] * 4 + [i32] * 6 + [nvcc.F32] + [i32] * n_ints + [p])
    return libs


def current_fa_abi(csrc: Path) -> bool:
    """Whether the earlier ``fa_flash_attention`` takes a kernel code and
    the current launch plan (d04f402's does not)."""
    return "int kernel," in (csrc / "flash_attention.cu").read_text()


def turns(before, after) -> dict:
    """Device ms of both versions, timed earlier, current, current,
    earlier."""
    b1, a1, a2, b2 = (cs.device_ms(f) for f in (before, after, after, before))
    return {"before_ms": [b1, b2], "after_ms": [a1, a2]}


def k3_rows(torch, lib, current_abi: bool, fak, ref, gen) -> list:
    """K3 at the LM shapes: the earlier kernel against the current one in
    turns, each held to the plain version at 2e-2 with its max error
    recorded.  An earlier source with the current interface takes the
    current plan at every shape; d04f402's takes its row kernel's plan at
    the two prefill shapes."""
    import math

    from repro_torch.kernels import _nvcc
    rows = []
    for name, case, window, _ in (cs.LM_FA_CASES if current_abi
                                  else cs.LM_FA_CASES[:2]):
        b, s, hq, hkv, d = case
        q, k, v = (torch.randn(b, s, h, d, generator=gen).to(
            "cuda", torch.bfloat16) for h in (hq, hkv, hkv))
        o = torch.empty_like(q)
        plan = fak.launch_plan(b, s, s, hq, hkv, d, torch.bfloat16, True)
        tail = ((fak.KERNELS.index(plan.kernel), plan.rows, plan.heads,
                 plan.lanes, plan.key_tile, plan.smem_bytes, plan.copy_width)
                if current_abi else (64, 1, 1, 0, 0, 2))

        def before():
            _nvcc.raise_on(lib.fa_flash_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b,
                s, s, hq, hkv, d, 1.0 / math.sqrt(d), 1, window or 0, 1,
                *tail, _nvcc.stream_of(q)), "before")

        def after():
            return fak.flash_attention(q, k, v, window=window)

        before()
        want = ref.flash_attention_ref(q, k, v, causal=True,
                                       window=window).float()
        row = {"kernel": name, "shape": [b, s, s, hq, hkv, d],
               "window": window, "plan": plan._asdict()}
        for side, got in (("before", o), ("after", after())):
            torch.testing.assert_close(got.float(), want, rtol=2e-2,
                                       atol=2e-2)
            row[f"{side}_max_abs_err"] = cs.max_abs(got, want)
        pairs = sum(min(r + 1, window or s) for r in range(s))
        bytes_moved = 2 * (2 * b * s * hq * d + 2 * b * s * hkv * d)
        row["bound_ms"] = max(bytes_moved / cs.HBM_BYTES_PER_S,
                              4 * d * pairs * b * hq / cs.BF16_FLOP_PER_S) \
            * 1e3
        rows.append({**row, **turns(before, after)})
    return rows


def main() -> int:
    import torch
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    from repro_torch.kernels import _nvcc
    from repro_torch.kernels import dp_clip_noise as dpk
    from repro_torch.kernels import flash_attention as fak
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as rgk

    card = cs.card_line()
    print(f"card: {card}")
    libs = build_before(Path(sys.argv[1]), _nvcc)
    _nvcc.build("rglru_scan", "dp_clip_noise", "flash_attention")
    gen = torch.Generator().manual_seed(11)
    rows = []

    for case in (cs.RG_PATH, cs.RG_RGLRU) if "rglru_scan" in libs else ():
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

    if "dp_clip_noise" in libs:
        r, p = cs.SLICE_ROWS, cs.SLICE_P
        x = torch.randn(r, p, generator=gen).cuda()
        out = torch.empty(r, device="cuda")

        def before_sq():
            _nvcc.raise_on(libs["dp_clip_noise"].dpcn_sumsq_rows(
                x.data_ptr(), out.data_ptr(), r, p, _nvcc.stream_of(x)),
                "before")

        before_sq()
        want = ref.sumsq_rows_ref(x)
        torch.testing.assert_close(out, want, rtol=1e-5, atol=0)
        torch.testing.assert_close(dpk.sumsq_rows(x), want, rtol=1e-5,
                                   atol=0)
        rows.append({"kernel": "sumsq_rows", "shape": [r, p],
                     "bound_ms": cs.sumsq_bound(r, p)[0],
                     **turns(before_sq, lambda: dpk.sumsq_rows(x))})
    if "flash_attention" in libs:
        rows += k3_rows(torch, libs["flash_attention"],
                        current_fa_abi(Path(sys.argv[1])), fak, ref, gen)

    floor_ms = cs.launch_floor_ms(torch)
    for row in rows:
        print(f"  {row['kernel']} {row['shape']}: before "
              f"{[round(t * 1e3, 3) for t in row['before_ms']]} us, after "
              f"{[round(t * 1e3, 3) for t in row['after_ms']]} us, floor "
              f"{floor_ms * 1e3:.3f} us, bound {row['bound_ms'] * 1e3:.3f} us"
              f"  ({card})")
        if "before_max_abs_err" in row:
            print(f"    max|err| vs plain: before "
                  f"{row['before_max_abs_err']:.3e}, after "
                  f"{row['after_max_abs_err']:.3e}")
    record = {"card": card, "launch_floor_ms": floor_ms, "rows": rows}
    out_dir = cs.ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "before_after.json").write_text(json.dumps(record, indent=1))
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
