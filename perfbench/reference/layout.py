"""The parameter layout both sides are handed, and the seeded weights.

A leaf is one tensor of the model: its path in the program's tree order
(dict keys sorted, list items in order, as the DP row and its noise are
laid out), its shape, its storage dtype and the rule its values follow.
The benchmark draws every weight from the seed itself, in one large
normal draw a storage dtype on the device, and hands the same values to
the program and to the reference.  Nothing here imports the program.

The values: N(0, 1/fan_in) for a projection (its true fan-in), N(0,
0.02²) for the embedding and an untied head, ones for a norm's scale;
the MoE router is f32, as the configuration states it, the rest in the
model's dtype.

A MoE layer may hold a share of its experts, as one of the cards that
share the layer by expert parallelism would: ``n_experts`` counts the
experts held, the first of them, and ``router_experts`` the published
routed experts (the router's width); without that key the layer holds
every expert.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

VOCAB_PAD_TO = 256


class Leaf(NamedTuple):
    path: Tuple
    shape: Tuple[int, ...]
    dtype: torch.dtype
    std: Optional[float]  # None: ones (a norm's scale)


def padded_vocab(vocab: int) -> int:
    return -(-vocab // VOCAB_PAD_TO) * VOCAB_PAD_TO


def sub_seed(seed: int, tag: str) -> int:
    """An independent 63-bit seed for one stream (weights, data, noise …)
    of a run's ``--seed``."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def head_dim(m: dict) -> int:
    return m.get("head_dim") or m["d_model"] // m["n_heads"]


def router_experts(m: dict) -> int:
    """The router's width of the MoE ``m``, of which its layers hold the
    first ``n_experts``."""
    e = m.get("router_experts", m["n_experts"])
    if not 0 < m["n_experts"] <= e:
        raise ValueError(f"{m['n_experts']} experts held of {e}")
    return e


def block_kind(m: dict) -> str:
    """The one block kind of the supported families: ``attn`` (dense) or
    ``moe``."""
    kinds = {"dense": "attn", "moe": "moe"}
    if (m.get("act", "swiglu") != "swiglu" or m.get("qkv_bias")
            or m.get("sliding_window") or m.get("mrope_sections")):
        raise ValueError("the reference runs SwiGLU blocks with full causal "
                         "attention, no qkv bias and plain rotary positions")
    if m["family"] not in kinds:
        raise ValueError(f"family {m['family']!r}: the reference runs "
                         f"{sorted(kinds)}")
    return kinds[m["family"]]


def leaves(m: dict) -> List[Leaf]:
    """Every leaf of the decoder-only LM ``m`` (a configuration's
    ``model`` dict), in tree order."""
    d, f, n = m["d_model"], m["d_ff"], m["n_layers"]
    hd = head_dim(m)
    hq, hkv = m["n_heads"] * hd, m["n_kv_heads"] * hd
    pv = padded_vocab(m["vocab_size"])
    dt = getattr(torch, m["dtype"])
    kind = block_kind(m)
    out = [Leaf(("embed", "table"), (pv, d), dt, 0.02),
           Leaf(("final_ln", "scale"), (d,), dt, None)]
    if not m["tie_embeddings"]:
        out.append(Leaf(("head", "w"), (d, pv), dt, 0.02))
    blk = ("stack", 0, "b0")
    block = {
        ("attn", "wk", "w"): ((d, hkv), dt, d),
        ("attn", "wo", "w"): ((hq, d), dt, hq),
        ("attn", "wq", "w"): ((d, hq), dt, d),
        ("attn", "wv", "w"): ((d, hkv), dt, d),
        ("ln1", "scale"): ((d,), dt, None),
        ("ln2", "scale"): ((d,), dt, None),
    }
    if kind == "attn":
        block.update({("mlp", "wg", "w"): ((d, f), dt, d),
                      ("mlp", "wi", "w"): ((d, f), dt, d),
                      ("mlp", "wo", "w"): ((f, d), dt, f)})
    else:
        e = m["n_experts"]
        block.update({("moe", "router"): ((d, router_experts(m)),
                                          torch.float32, d),
                      ("moe", "wg"): ((e, d, f), dt, d),
                      ("moe", "wi"): ((e, d, f), dt, d),
                      ("moe", "wo"): ((e, f, d), dt, f)})
    for key in sorted(block):
        shape, dtype, fan_in = block[key]
        std = None if fan_in is None else 1.0 / math.sqrt(fan_in)
        out.append(Leaf(blk + key, (n,) + shape, dtype, std))
    return out


def n_elements(lv: List[Leaf]) -> int:
    return sum(math.prod(x.shape) for x in lv)


def make_weights(lv: List[Leaf], seed: int, device) -> Dict[Tuple, torch.Tensor]:
    """The seeded values of every leaf, ``{path: tensor}``: one standard
    normal draw over a flat buffer a storage dtype, on ``device`` from a
    ``torch.Generator`` there, each leaf a view of its buffer scaled in
    place (a norm's filled with ones).  The same seed gives the same
    values on the same kind of device."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    out = {}
    for dtype in sorted({x.dtype for x in lv}, key=str):
        group = [x for x in lv if x.dtype == dtype]
        flat = torch.empty(n_elements(group), dtype=dtype, device=device)
        flat.normal_(generator=gen)
        off = 0
        for x in group:
            size = math.prod(x.shape)
            view = flat[off:off + size].view(x.shape)
            if x.std is None:
                view.fill_(1.0)
            else:
                view.mul_(x.std)
            out[x.path] = view
            off += size
    return out


def as_tree(values: Dict[Tuple, torch.Tensor]):
    """``{path: tensor}`` as nested dicts, a list where a key is an int."""
    root: dict = {}
    for path, t in values.items():
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return _lists(root)


def _lists(node):
    if not isinstance(node, dict):
        return node
    if node and all(isinstance(k, int) for k in node):
        return [_lists(node[i]) for i in range(len(node))]
    return {k: _lists(v) for k, v in node.items()}
