"""Analytic FLOP / HBM-byte model per (arch x shape).

The reference's cost model, kept as it is: ``launch/dryrun`` prices every
(arch x shape) cell with it, and ``analysis/roofline.Roofline`` turns the
counts into times at the H100's peaks.  In the reference it stands in for
XLA's cost analysis, which counts a scanned layer once; the port's dry run
counts every op of a fake step with ``FlopCounterMode`` as well and keeps
that count beside this one (``counted_flops``), and
``tests/test_torch_costmodel.py`` holds the two against each other at
reduced scale for every family, in the reference's bands.

Conventions: counted FLOPs are the COMPUTED ones (the blocked attention
computes full S x Skv rectangles, masked lanes included — what the
reference's kernel executes, and what ``flash_attention``'s FLOP formula
counts).  Backward pass = 2x forward matmul FLOPs; remat: 'full'
recomputes the forward (+1x), 'dots' recomputes only cheap ops
(+epsilon, ignored).
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeConfig

BP = {"float32": 4, "bfloat16": 2, "float16": 2}


def mm(m, n, k):
    return 2.0 * m * n * k


# --- per-layer forward FLOPs -------------------------------------------------
def _attn_flops(cfg, B, S, Skv, d_model=None, n_heads=None, n_kv=None,
                hd=None):
    d = d_model or cfg.d_model
    h = n_heads or cfg.n_heads
    hk = n_kv or cfg.n_kv_heads
    hd = hd or cfg.hd
    f = mm(B * S, h * hd, d) + 2 * mm(B * S, hk * hd, d)    # qkv proj
    f += 2 * mm(B * S, Skv, h * hd)                          # qk^T and pv
    f += mm(B * S, d, h * hd)                                # out proj
    return f


def _mlp_flops(cfg, B, S, d=None, ff=None):
    d = d or cfg.d_model
    ff = ff or cfg.d_ff
    return 3 * mm(B * S, ff, d)


def _moe_flops(cfg, B, S):
    n = B * S
    cap = max(8, -(-int(n * cfg.experts_per_token * cfg.capacity_factor /
                        cfg.n_experts) // 8) * 8)
    f = mm(n, cfg.n_experts, cfg.d_model)                    # router
    f += 3 * mm(cfg.n_experts * cap, cfg.moe_d_ff, cfg.d_model)
    if cfg.n_shared_experts:
        f += 3 * mm(n, cfg.n_shared_experts * cfg.moe_d_ff, cfg.d_model)
    return f


def _linear_scan_flops(B, S, H, dk, dv, chunk):
    """chunked_scan: intra qk/y + inter + carry terms (ssm_common)."""
    c = min(chunk, S)
    f = 2 * B * H * S * c * dk          # intra scores (q k^T per chunk)
    f += 2 * B * H * S * c * dv         # intra y = scores @ v
    f += 2 * 2 * B * H * S * dk * dv    # carry outer products (C, and w_end)
    f += 2 * B * H * S * dk * dv        # inter y = q @ C_in
    f += 2 * B * H * S * dk             # normalizer terms
    return f


def _mlstm_flops(cfg, B, S):
    di = cfg.d_model * cfg.ssm_expand
    h = cfg.n_heads
    dh = di // h
    f = 4 * mm(B * S, di, cfg.d_model)                       # q k v z
    f += mm(B * S, 2 * h, cfg.d_model)                       # gates
    f += _linear_scan_flops(B, S, h, dh, dh, cfg.ssm_chunk)
    f += mm(B * S, cfg.d_model, di)                          # out proj
    return f


def _slstm_flops(cfg, B, S):
    di = cfg.d_model * cfg.ssm_expand
    h = cfg.n_heads
    dh = di // h
    f = mm(B * S, 4 * di, cfg.d_model)                       # x gates
    f += S * 4 * 2.0 * B * h * dh * dh                       # recurrent R h
    f += mm(B * S, cfg.d_model, di)                          # out proj
    return f


def _mamba_flops(cfg, B, S):
    di = cfg.d_model * cfg.ssm_expand
    h = cfg.ssm_heads or max(1, di // 64)
    p = di // h
    n = cfg.ssm_state
    conv_dim = di + 2 * n
    f = mm(B * S, 2 * di + 2 * n + h, cfg.d_model)           # in proj
    f += 2.0 * B * S * conv_dim * cfg.ssm_conv               # conv
    f += _linear_scan_flops(B, S, h, n, p, cfg.ssm_chunk)
    f += mm(B * S, cfg.d_model, di)                          # out proj
    return f


def _zamba_shared_flops(cfg, B, S, Skv):
    d2 = 2 * cfg.d_model
    f = _attn_flops(cfg, B, S, Skv, d_model=d2, hd=d2 // cfg.n_heads)
    f += _mlp_flops(cfg, B, S, d=d2, ff=cfg.d_ff)
    f += mm(B * S, cfg.d_model, d2)                          # down proj
    return f


def fwd_flops(cfg: ModelConfig, B: int, S: int, Skv: int | None = None) -> float:
    """Forward FLOPs for S new positions attending to Skv (decode: S=1)."""
    Skv = Skv or S
    fam = cfg.family
    f = 0.0
    if fam in ("dense", "moe", "vlm"):
        from repro_torch.models.transformer import pattern_of

        pattern = pattern_of(cfg)
        n_rep = cfg.n_layers // len(pattern)
        for kind in pattern:
            # NOTE: the blocked implementation computes full S x Skv
            # rectangles (masked lanes included), so local layers cost the
            # same as global ones today — window-skipping is an optimization
            # opportunity.
            f += n_rep * _attn_flops(cfg, B, S, Skv)
            f += n_rep * (_moe_flops(cfg, B, S) if kind == "moe"
                          else _mlp_flops(cfg, B, S))
        if fam == "vlm" and S > 1:
            f += mm(B * cfg.n_patches, cfg.d_model, cfg.frontend_dim)
    elif fam == "xlstm":
        from repro_torch.models.xlstm import pattern_of as xp

        pattern = xp(cfg)
        n_rep = cfg.n_layers // len(pattern)
        for kind in pattern:
            f += n_rep * (_mlstm_flops(cfg, B, S) if kind == "m"
                          else _slstm_flops(cfg, B, S))
    elif fam == "hybrid":
        every = cfg.shared_attn_every or cfg.n_layers
        n_groups = cfg.n_layers // every
        f += cfg.n_layers * _mamba_flops(cfg, B, S)
        f += n_groups * _zamba_shared_flops(cfg, B, S, Skv)
    elif fam == "encdec":
        s_src = Skv if S == 1 else S  # encoder length
        if S > 1:  # encoder runs on train/prefill only
            for _ in range(cfg.n_enc_layers):
                f += _attn_flops(cfg, B, s_src, s_src)
                f += _mlp_flops(cfg, B, s_src)
        for _ in range(cfg.n_dec_layers):
            f += _attn_flops(cfg, B, S, Skv)        # self
            f += _attn_flops(cfg, B, S, s_src)      # cross
            f += _mlp_flops(cfg, B, S)
    else:
        raise ValueError(fam)
    f += mm(B * S, cfg.vocab_size, cfg.d_model)              # logits
    return f


def step_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        if cfg.family == "encdec":
            fwd = fwd_flops(cfg, B, S // 2, S // 2)
        elif cfg.family == "vlm":
            fwd = fwd_flops(cfg, B, S, S)  # patches + text ≈ S total
        else:
            fwd = fwd_flops(cfg, B, S, S)
        mult = 3.0 + (1.0 if cfg.remat == "full" else 0.0)
        return fwd * mult
    if shape.kind == "prefill":
        if cfg.family == "encdec":
            # prefill computes last-position logits only
            return fwd_flops(cfg, B, S // 2, S // 2) \
                - mm(B * (S // 2 - 1), cfg.vocab_size, cfg.d_model)
        return fwd_flops(cfg, B, S, S) - mm(B * (S - 1), cfg.vocab_size,
                                            cfg.d_model)
    # decode: one token against a Skv cache
    return fwd_flops(cfg, B, 1, S)


# --- HBM traffic model -------------------------------------------------------
def step_bytes(cfg: ModelConfig, shape: ShapeConfig, n_params: int) -> float:
    """First-order HBM bytes per step (the reference's estimate):
    params (fwd read + bwd read + grad write + f32 Adam m/v read+write),
    residual-stream activation traffic, attention KV/cache traffic."""
    bp = BP.get(cfg.dtype, 2)
    B, S = shape.global_batch, shape.seq_len
    d = cfg.d_model
    L = cfg.n_layers
    if shape.kind == "train":
        param_traffic = n_params * (bp * 2 + 4 + 16 + bp)   # fwd+bwd, g, mv, w
        act_coeff = 14 if cfg.remat == "none" else 20        # incl. recompute
        act = L * B * S * d * bp * act_coeff
        return param_traffic + act
    if shape.kind == "prefill":
        cache = L * B * S * cfg.n_kv_heads * cfg.hd * 2 * bp
        act = L * B * S * d * bp * 8
        return n_params * bp + act + cache
    # decode: weights + full cache read + one-position write
    if cfg.family == "xlstm":
        di = d * cfg.ssm_expand
        dh = di // cfg.n_heads
        state = L * B * cfg.n_heads * (dh * dh + 2 * dh) * 4
        return n_params * bp + 2 * state
    if cfg.family == "hybrid":
        di = d * cfg.ssm_expand
        h = cfg.ssm_heads or di // 64
        p = di // h
        state = L * B * h * (cfg.ssm_state * p) * 4
        n_shared = cfg.n_layers // (cfg.shared_attn_every or cfg.n_layers)
        kv = n_shared * B * S * cfg.n_heads * (2 * d // cfg.n_heads) * 2 * bp
        return n_params * bp + 2 * state + kv
    kv_layers = cfg.n_dec_layers if cfg.family == "encdec" else L
    cache = kv_layers * B * S * cfg.n_kv_heads * cfg.hd * 2 * bp
    return n_params * bp + cache
