"""Analytic parameter counts and model FLOPs of every (arch x shape) cell.

The port of ``repro.launch.roofline``'s arithmetic, held equal (``==``) to
the reference's for every ``configs.archs.cells()`` entry:

    train:   6 * N_active * tokens  + attention term
    prefill: 2 * N_active * tokens  + attention term
    decode:  2 * N_active * batch   + the attention's KV-read term

``param_counts`` counts no norm weights and no biases, as the reference
does (qwen3-4b: 4,026,531,840, where its tensors hold 4,026,727,936).
``step_flops`` takes a run's own batch and sequence, so ``chip_smoke.py``
can count the work of the batch it trains.

``analyze_cell`` and ``render_table`` read the records of
``launch/dryrun.py``, which come from a dispatch trace of fake tensors on
a mesh of H100 cards, not from HLO: the three terms of the reference's
roofline, each a card's time, are its FLOPs over 989 TFLOP/s, the bytes
its ops read and write one by one (eager PyTorch's unfused traffic) over
3.35 TB/s, and each mesh axis's collective bytes over that axis's
bandwidth (``mesh.axis_bandwidth``, by its width in the record's mesh).
``CHIPS`` is the dry run's default card count (the reference's 256-chip
pod); a record carries its own.
"""
from __future__ import annotations

import json

from repro_torch.configs.archs import ARCHS, SHAPES
from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16, axis_bandwidth
from repro_torch.models.common import ModelConfig, padded_vocab
from repro_torch.models.recurrent import ssd_dims

CHIPS = 256


def param_counts(cfg: ModelConfig) -> tuple[float, float]:
    """(total, active-per-token) parameter counts."""
    D = cfg.d_model
    hd = cfg.hd if cfg.num_heads else 0  # attn-free archs (mamba2)
    embed = padded_vocab(cfg.vocab_size) * D * (1 if cfg.tie_embeddings else 2)
    total = embed
    active = embed
    specs = list(cfg.pattern) * cfg.num_blocks + list(cfg.tail)
    for spec in specs:
        if spec.kind in ("global", "local"):
            attn = D * hd * (cfg.num_heads + 2 * cfg.num_kv_heads) \
                + cfg.num_heads * hd * D
            total += attn
            active += attn
        elif spec.kind == "rglru":
            r = D * cfg.rglru_width * 2 + 7 * cfg.rglru_width
            total += r
            active += r
        elif spec.kind == "ssd":
            H, P, N = ssd_dims(cfg)
            r = D * (2 * H * P + 2 * N + H) + H * P * D + H * P
            total += r
            active += r
        if cfg.is_moe:
            per_exp = 3 * D * cfg.moe_d_ff
            total += cfg.num_experts * per_exp + D * cfg.num_experts
            active += cfg.num_experts_per_tok * per_exp + D * cfg.num_experts
        elif cfg.d_ff:
            m = 3 * D * cfg.d_ff
            total += m
            active += m
        if cfg.encoder_layers:  # cross attention in decoder layers
            c = 2 * D * hd * (cfg.num_heads + cfg.num_kv_heads)
            total += c
            active += c
    if cfg.encoder_layers:
        enc = cfg.encoder_layers * (
            D * hd * (cfg.num_heads + 2 * cfg.num_kv_heads)
            + cfg.num_heads * hd * D + 3 * D * cfg.d_ff)
        total += enc
        active += enc
    return float(total), float(active)


def step_flops(cfg: ModelConfig, kind: str, B: int, S: int) -> float:
    """Analytic useful FLOPs of one step of ``kind`` ("train", "prefill" or
    "decode") at batch ``B`` and sequence (or context) ``S``."""
    total, active = param_counts(cfg)
    specs = list(cfg.pattern) * cfg.num_blocks + list(cfg.tail)

    if kind == "train":
        tokens = B * S
        flops = 6.0 * active * tokens
        # attention scores+values: 12 * B * S * S_eff * H * hd per attn layer
        for spec in specs:
            if spec.kind in ("global", "local"):
                s_eff = min(spec.window or S, S) if spec.kind == "local" else S
                flops += 12.0 * B * S * (s_eff / 2 if spec.kind != "local"
                                         else s_eff) * cfg.num_heads * cfg.hd
        return flops
    if kind == "prefill":
        tokens = B * S
        flops = 2.0 * active * tokens
        for spec in specs:
            if spec.kind in ("global", "local"):
                s_eff = min(spec.window or S, S) if spec.kind == "local" else S
                flops += 4.0 * B * S * (s_eff / 2 if spec.kind != "local"
                                        else s_eff) * cfg.num_heads * cfg.hd
        return flops
    # decode: one token per sequence
    flops = 2.0 * active * B
    for spec in specs:
        if spec.kind in ("global", "local"):
            s_eff = min(spec.window or S, S) if spec.kind == "local" else S
            flops += 4.0 * B * s_eff * cfg.num_heads * cfg.hd
    return flops


def model_flops(arch: str, shape: str) -> float:
    """Analytic useful FLOPs for one step of this cell."""
    sh = SHAPES[shape]
    return step_flops(ARCHS[arch], sh["kind"], sh["global_batch"],
                      sh["seq_len"])


def axis_widths(mesh_name: str) -> dict:
    """{axis: width} of a record's mesh name ("32x8", "2x16x16": the
    axes ("pod",) "data", "model"); {} for a name of another form."""
    try:
        sizes = [int(n) for n in mesh_name.split("x")]
    except ValueError:
        return {}
    names = ("pod", "data", "model")[-len(sizes):] if len(sizes) <= 3 else ()
    return dict(zip(names, sizes))


def analyze_cell(cell: dict) -> dict:
    """The roofline of one dry-run record with ``costs`` (every term a
    card's; ``model_flops`` is the global step's, divided by the record's
    card count where the two are compared)."""
    costs = cell["costs"]
    cards = cell["chips"]
    t_compute = costs["flops"] / PEAK_FLOPS_BF16
    t_memory = costs["op_bytes"] / HBM_BW
    width = axis_widths(cell.get("mesh", ""))
    t_collective = sum(b / axis_bandwidth(axis, cards, width.get(axis))
                       for by_axis in costs["coll_bytes"].values()
                       for axis, b in by_axis.items())
    terms = dict(compute=t_compute, memory=t_memory, collective=t_collective)
    bound = max(terms, key=terms.get)
    mf = model_flops(cell["arch"], cell["shape"])
    step = max(terms.values())
    return dict(
        t_compute=t_compute, t_memory=t_memory, t_collective=t_collective,
        bound=bound, model_flops=mf,
        useful_ratio=mf / max(costs["flops"] * cards, 1.0),
        step_time=step, mfu=mf / cards / PEAK_FLOPS_BF16 / step)


def render_table(path: str) -> str:
    """The roofline of every probed record in a dry-run JSON file, as a
    markdown table."""
    with open(path) as f:
        cells = json.load(f)
    rows = ["| arch | shape | compute s | memory s | collective s | bound | "
            "MODEL/HLO | roofline MFU |",
            "|---|---|---|---|---|---|---|---|"]
    for c in cells:
        if c.get("status") != "ok" or "costs" not in c:
            continue
        r = analyze_cell(c)
        rows.append(
            f"| {c['arch']} | {c['shape']} | {r['t_compute']:.2e} | "
            f"{r['t_memory']:.2e} | {r['t_collective']:.2e} | {r['bound']} | "
            f"{r['useful_ratio']:.2f} | {r['mfu']:.1%} |")
    return "\n".join(rows)


if __name__ == "__main__":
    import sys
    print(render_table(sys.argv[1] if len(sys.argv) > 1
                       else "results/dryrun.json"))
