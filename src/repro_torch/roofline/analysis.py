"""Three-term roofline analysis of the port's dry-run jobs on the H100,
after ``src/repro/roofline/analysis.py``:

    compute_s    = FLOPs_global / (ranks * peak_flops)
    memory_s     = HBM_bytes_global / (ranks * hbm_bw)
    collective_s = collective_bytes_per_rank / link_bw

Compute and memory come from the reference's analytic accounting (the
same matmul, attention, scan and MoE-dispatch terms of the architecture
config, the standard MFU method), divided over the ranks as if the work
split evenly. The traced counts of ``obs.profile`` (the dry run's meta
trace of the step, ``launch/dryrun.py``) stand beside them, as the
reference keeps XLA's ``hlo_*_body_once``.

The collective term is the port's own layout (``launch/fsdp.py`` over the
model axis, the single-sync schedule over the data axes) counted
analytically, since the dry run spawns no ranks: :func:`collective_bytes`.

Hardware: NVIDIA H100 SXM5, from NVIDIA's H100 data sheet: 989 TFLOP/s
dense bf16 and fp16 on the tensor cores, 67 TFLOP/s f32 on the CUDA
cores, 3.35 TB/s HBM3, 80 GB. Links: NVLink 4 gives a card 900 GB/s
(450 GB/s each way) to the other seven of an HGX node (data sheet); beyond
the node each card has one 400 Gb/s NDR InfiniBand port (ConnectX-7, the
DGX H100 reference layout): 50 GB/s each way. A group of ranks that spans
nodes runs at the network's rate.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

from repro_torch import tree as tu

PEAK_FLOPS = 989e12       # dense bf16 / fp16, per card
PEAK_FLOPS_F32 = 67e12    # f32 on the CUDA cores, per card
HBM_BW = 3.35e12          # bytes / s / card
HBM_BYTES = 80 * 10**9    # bytes of HBM3 per card
NVLINK_BW = 450e9         # bytes / s / card, each way, within a node of 8
NETWORK_BW = 50e9         # bytes / s / card, each way, across nodes (400 Gb/s)
NODE_CARDS = 8

ACT_BYTES = 2  # bf16 activations
LOGIT_BYTES = 4  # f32 logits
META_FRACTION = 8  # meta batch = base batch / 8 in the SAMA train job


def peak_flops(dtype) -> float:
    """The card's dense peak for a compute dtype (a ``torch.dtype`` or its
    name): bf16 and fp16 on the tensor cores, f32 on the CUDA cores."""
    name = str(dtype).replace("torch.", "")
    return PEAK_FLOPS_F32 if name in ("float32", "float") else PEAK_FLOPS


def param_counts(param_shapes) -> Dict[str, int]:
    """Total, expert and embedding parameter counts of a tree of tensors
    (or of anything with a ``shape``), keyed as the reference keys them."""
    total = experts = embed = 0
    names, leaves = tu.flatten_with_keys(param_shapes)
    for key, leaf in zip(names, leaves):
        n = math.prod(leaf.shape)
        total += n
        if "experts" in key:
            experts += n
        if "embed" in key:  # embed + pos_embed: gathers, not matmuls
            embed += n
    return {"total": total, "experts": experts, "embed": embed}


# ---------------------------------------------------------------------------
# analytic FLOPs
# ---------------------------------------------------------------------------


def _attn_flops(cfg, batch, s_q, t_kv):
    """Self/cross attention score+AV flops for one forward pass, per layer."""
    if cfg.use_mla:
        dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        return 2 * batch * cfg.num_heads * s_q * t_kv * (dn + dr + dv)
    return 4 * batch * cfg.num_heads * s_q * t_kv * cfg.head_dim


def _moe_dispatch_flops(cfg, tokens):
    """GShard one-hot dispatch + combine einsums per MoE layer."""
    from repro_torch.models.moe import MOE_GROUP

    g = min(MOE_GROUP, tokens)
    cap = max(int(cfg.capacity_factor * cfg.top_k * g / cfg.num_experts), 4)
    per_group = 2 * g * cfg.num_experts * cap * cfg.d_model * 2  # dispatch+combine
    return (tokens // g) * per_group


def _ssm_scan_flops(cfg, batch, seq):
    """Mamba2 SSD chunkwise flops per layer (intra matmuls + state updates)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    n = cfg.ssm_state
    q = min(cfg.ssm_chunk, seq)
    intra = 2 * batch * seq * q * (n + d_inner)
    inter = 4 * batch * seq * d_inner * n
    return intra + inter


def _rwkv_scan_flops(cfg, batch, seq):
    d = cfg.d_model
    k = cfg.rwkv_head_dim
    q = min(cfg.ssm_chunk, seq)
    intra = 4 * batch * seq * q * d  # (i,j,channel) products
    inter = 4 * batch * seq * d * k
    return intra + inter


def forward_flops(cfg, counts, batch, s_q, t_kv=None) -> float:
    """One forward pass over (batch, s_q) query tokens (kv length t_kv)."""

    t_kv = t_kv if t_kv is not None else s_q
    tokens = batch * s_q

    n_matmul = counts["total"] - counts["embed"] - counts["experts"]
    n_matmul += cfg.vocab_size * cfg.d_model  # tied unembed
    if cfg.num_experts:
        n_matmul += counts["experts"] * cfg.top_k / cfg.num_experts
    total = 2.0 * tokens * n_matmul

    fam = cfg.family
    if fam in ("dense", "encoder", "moe"):
        for kind in cfg.layer_kinds:
            t_eff = (min(cfg.sliding_window, t_kv) if (kind == "local" and cfg.sliding_window)
                     else t_kv)
            total += _attn_flops(cfg, batch, s_q, t_eff)
        if fam == "moe":
            total += (cfg.num_layers - cfg.first_k_dense) * _moe_dispatch_flops(cfg, tokens)
    elif fam == "hybrid":
        n_groups = cfg.num_layers // cfg.hybrid_attn_every
        total += cfg.num_layers * _ssm_scan_flops(cfg, batch, s_q)
        total += n_groups * _attn_flops(cfg, batch, s_q, t_kv)
    elif fam == "ssm":
        total += cfg.num_layers * _rwkv_scan_flops(cfg, batch, s_q)
    elif fam == "vlm":
        n_groups = cfg.num_layers // cfg.cross_attn_every
        n_self = n_groups * (cfg.cross_attn_every - 1)
        total += n_self * _attn_flops(cfg, batch, s_q, t_kv)
        total += n_groups * _attn_flops(cfg, batch, s_q, cfg.vision_tokens)
    elif fam == "audio":
        f = cfg.encoder_seq
        total += cfg.encoder_layers * _attn_flops(cfg, batch, f, f)  # encoder (every fwd)
        total += cfg.num_layers * (_attn_flops(cfg, batch, s_q, t_kv)
                                   + _attn_flops(cfg, batch, s_q, f))
    return total


def step_flops(cfg, counts, shape, kind: str) -> float:
    """Whole-step analytic flops. Train = the SAMA bilevel step:
    base fwd+bwd (3x fwd) + meta pass (3x fwd, B/8) + 2 central-difference
    forwards (their lambda-backward is cut by the feature stop-gradient)."""

    b, s = shape.global_batch, shape.seq_len
    if kind == "train":
        f_base = forward_flops(cfg, counts, b, s)
        f_meta = forward_flops(cfg, counts, max(b // META_FRACTION, 1), s)
        return 3 * f_base + 3 * f_meta + 2 * f_base
    if kind == "prefill":
        return forward_flops(cfg, counts, b, s)
    # decode: one token against a cache of length seq_len
    if cfg.family == "audio":
        # decode does NOT rerun the encoder (cross-kv cached)
        f = forward_flops(cfg, counts, b, 1, t_kv=s)
        f -= cfg.encoder_layers * _attn_flops(cfg, b, cfg.encoder_seq, cfg.encoder_seq)
        return f
    return forward_flops(cfg, counts, b, 1, t_kv=s)


# ---------------------------------------------------------------------------
# analytic HBM traffic
# ---------------------------------------------------------------------------


def _activation_traffic(cfg, batch, s_q, t_kv) -> float:
    """Rough per-pass activation HBM traffic: ~8 read/writes of the residual
    stream per block plus attention score materialization (f32 read+write)."""

    tokens = batch * s_q
    blocks = cfg.num_layers + (cfg.encoder_layers if cfg.family == "audio" else 0)
    stream = 8.0 * tokens * cfg.d_model * ACT_BYTES * blocks
    scores = 0.0
    if cfg.family in ("dense", "encoder", "moe", "vlm", "audio"):
        for kind in cfg.layer_kinds:
            t_eff = (min(cfg.sliding_window, t_kv) if (kind == "local" and cfg.sliding_window)
                     else t_kv)
            scores += 8.0 * batch * cfg.num_heads * s_q * t_eff  # f32 write+read
    logits = 0.0
    if cfg.family != "encoder":
        logits = tokens * cfg.vocab_size * LOGIT_BYTES
    return stream + scores + logits


def step_bytes(cfg, counts, shape, kind: str, cache_bytes: int = 0) -> float:
    b, s = shape.global_batch, shape.seq_len
    params_bytes = counts["total"] * ACT_BYTES  # bf16 params in the dry run
    if kind == "train":
        # fwd reads W; bwd reads W + writes grad; x4 passes; optimizer reads/
        # writes the moments: ~8x params traffic total
        t = 8.0 * params_bytes
        t += 3.0 * _activation_traffic(cfg, b, s, s)  # base fwd+bwd
        t += 3.0 * _activation_traffic(cfg, max(b // META_FRACTION, 1), s, s)
        t += 2.0 * _activation_traffic(cfg, b, s, s)  # central-difference fwds
        return t
    if kind == "prefill":
        return params_bytes + _activation_traffic(cfg, b, s, s)
    # decode: params once + cache read/write + small activations
    t = params_bytes + 2.0 * cache_bytes
    t += _activation_traffic(cfg, b, 1, s)
    return t


# ---------------------------------------------------------------------------
# the port's collectives
# ---------------------------------------------------------------------------


def link_bw(group_size: int, stride: int) -> float:
    """Each-way rate of a ring over ``group_size`` ranks ``stride`` apart
    in the world's row-major layout: NVLink when the group fits in one node
    of eight, the network otherwise."""
    return NVLINK_BW if group_size * stride <= NODE_CARDS else NETWORK_BW


def collective_bytes(kind: str, mesh_shape: Dict[str, int], param_bytes: float,
                     lam_bytes: float, unroll: int = 1) -> Dict[str, float]:
    """Bytes one rank sends for one step of the port's layout, by group:

    * model group (``launch/fsdp.py``): each of the SAMA step's K + 3 loss
      evaluations (K base steps, the meta pass, two central-difference
      passes) all-gathers the (m - 1)/m of theta a rank lacks, and each of
      its K + 1 theta gradients is reduce-scattered, sending the same;
    * data group (single-sync): K all-reduces of the rank's gradient block
      and one of the meta bucket (lambda's gradient), a ring all-reduce
      sending 2 (n - 1)/n of its bytes.

    ``param_bytes`` is theta's whole size. Serving takes no mesh in the
    port (nor in the reference), so prefill and decode send nothing."""
    m = mesh_shape.get("model", 1)
    n = 1
    for a in ("pod", "data"):
        n *= mesh_shape.get(a, 1)
    out = {"model": 0.0, "data": 0.0}
    if kind != "train":
        return out
    if m > 1:
        share = param_bytes * (m - 1) / m
        out["model"] = (unroll + 3) * share + (unroll + 1) * share
    if n > 1:
        block = param_bytes / m
        out["data"] = 2.0 * (n - 1) / n * (unroll * block + lam_bytes)
    return out


# ---------------------------------------------------------------------------
# the report
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Roofline:
    name: str
    flops_global: float
    bytes_global: float
    collective_bytes_per_device: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    useful_ratio: float  # model matmul flops / total analytic flops
    #: bytes a rank holds: parameters, optimizer moments, cache (its blocks)
    per_rank_bytes: Dict[str, float]
    #: the meta trace's counts of the whole (global) step (``obs.profile``)
    traced_flops: Optional[float]
    traced_bytes: Optional[float]
    traced_matmul_flops: Optional[float]
    collectives: Dict[str, Any]

    def as_dict(self):
        return dataclasses.asdict(self)


def analyze(name: str, cfg, shape, kind: str, param_shapes, n_devices: int, *,
            mesh_shape: Optional[Dict[str, int]] = None, cache_shapes=None,
            per_rank_bytes: Optional[Dict[str, float]] = None, traced=None,
            lam_bytes: float = 0.0, unroll: int = 1) -> Roofline:
    """The roofline record of one job. ``traced`` is the job's attribution
    (``obs.profile.attribute``) or None."""
    counts = param_counts(param_shapes)
    cache_bytes = 0
    if cache_shapes is not None:
        for leaf in tu.flatten_with_keys(cache_shapes)[1]:
            cache_bytes += math.prod(leaf.shape) * leaf.element_size()

    flops = step_flops(cfg, counts, shape, kind)
    mem = step_bytes(cfg, counts, shape, kind, cache_bytes)
    mesh_shape = mesh_shape or {}
    param_bytes = sum(math.prod(x.shape) * x.element_size()
                      for x in tu.flatten_with_keys(param_shapes)[1])
    coll = collective_bytes(kind, mesh_shape, param_bytes, lam_bytes, unroll)
    m = mesh_shape.get("model", 1)
    n = n_devices // max(m, 1)
    coll_s = (coll["model"] / link_bw(m, 1) if m > 1 else 0.0) \
        + (coll["data"] / link_bw(n, m) if n > 1 else 0.0)

    compute_s = flops / (n_devices * PEAK_FLOPS)
    memory_s = mem / (n_devices * HBM_BW)
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    dominant = max(terms, key=terms.get)

    # "useful" = pure matmul-param flops (6ND-style) over everything the step does
    n_matmul = (counts["total"] - counts["embed"] - counts["experts"]
                + cfg.vocab_size * cfg.d_model)
    if cfg.num_experts:
        n_matmul += counts["experts"] * cfg.top_k / cfg.num_experts
    tokens = shape.global_batch * shape.seq_len
    if kind == "train":
        useful = (6 + 6 / META_FRACTION + 4) * n_matmul * tokens
    elif kind == "prefill":
        useful = 2 * n_matmul * tokens
    else:
        useful = 2 * n_matmul * shape.global_batch
    useful_ratio = useful / flops if flops else 0.0

    total = (traced or {}).get("total") or {}
    return Roofline(
        name=name, flops_global=flops, bytes_global=mem,
        collective_bytes_per_device=coll["model"] + coll["data"],
        compute_s=compute_s, memory_s=memory_s, collective_s=coll_s, dominant=dominant,
        useful_ratio=useful_ratio, per_rank_bytes=dict(per_rank_bytes or {}),
        traced_flops=total.get("flops"), traced_bytes=total.get("bytes"),
        traced_matmul_flops=total.get("matmul_flops"),
        collectives={"model_bytes": coll["model"], "data_bytes": coll["data"],
                     "model_link_bw": link_bw(m, 1) if m > 1 else None,
                     "data_link_bw": link_bw(n, m) if n > 1 else None},
    )
