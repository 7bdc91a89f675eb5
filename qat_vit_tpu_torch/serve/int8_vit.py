"""True-int8 ViT inference: convert + the serving forward (port of
``qat_vit_tpu/serve/int8_vit.py``).

- :func:`convert_vit`: float params + observer stats → the int8 export, the
  same nested dict as the JAX package's (``str(i)`` block keys,
  ``w_int8 [K, N]``, ``w_colsum``, ``w_scale``, ``bias``, ``out_q``), as CPU
  tensors. :func:`export_to_device` moves it to a device, leaving the 0-d
  qparams on the host so the kernels' scalar arguments cost no device sync.
- :func:`int8_apply`: ``fused="none"`` is the exact path (plain PyTorch:
  f32 stream, erf-GELU, quantize by division, float64-exact int GEMMs;
  ``attn_impl="pallas_long"`` puts its attention on the long attention
  kernel, K5a); ``fused="megamodel"`` is K4's block chain through the CUDA
  kernels (``ops/block_kernel.py``), ``"megamodel_long"`` /
  ``"megablock_long"`` K6's (``ops/long_block_kernel.py``), with the
  patch-embed and head GEMMs on the ``int8_gemm`` kernel too; each
  ``*_plain`` twin runs that same chain through the kernels' plain
  versions (the card's reference for them). Feature-mode towers
  (``num_classes=0``) return the dequantized final-LN tokens.
- :func:`serving_preset`: ``{}`` on the CPU; on CUDA the megamodel chain,
  or megamodel_long for long sequences, in bf16 with tanh-GELU (or the
  model's quick-GELU), for the geometries their kernels accept.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from qat_vit_tpu_torch.models.vit import ViTConfig, extract_patches
from qat_vit_tpu_torch.ops.block_kernel import KERNEL_OPS, PLAIN_OPS, model_forward
from qat_vit_tpu_torch.ops.flash_attention import attention_shapes_ok, xla_attention_qkv
from qat_vit_tpu_torch.ops.fused_serve import gemm_shapes_ok, int8_dense_plain, layernorm_f32
from qat_vit_tpu_torch.ops.long_attention import long_attention_qkv
from qat_vit_tpu_torch.ops.long_block_kernel import (
    LONG_KERNEL_OPS,
    LONG_PLAIN_OPS,
    long_block_forward,
    long_megablock_shapes_ok,
    long_model_forward,
)
from qat_vit_tpu_torch.ops.quantized_matmul import f32, quantize_act_shifted, quantized_dense
from qat_vit_tpu_torch.quant.convert import act_output_qparams, act_qparams, dense_int8, ln_params
from qat_vit_tpu_torch.quant.qconfig import default_qat_qconfig


def _stats(quant_stats: Dict[str, torch.Tensor], prefix: str) -> Dict[str, Any]:
    """The observer buffers under ``prefix`` as ``{site: {min_val, max_val}}``."""
    out: Dict[str, Any] = {}
    for site in ("weight_fq", "act_fq"):
        key = f"{prefix}.{site}.min_val"
        if key in quant_stats:
            out[site] = {"min_val": quant_stats[key],
                         "max_val": quant_stats[f"{prefix}.{site}.max_val"]}
    return out


def convert_vit(
    params: Dict[str, torch.Tensor],  # the float model's state_dict
    quant_stats: Dict[str, torch.Tensor],  # observer buffers (…min_val / …max_val)
    cfg: ViTConfig,
    per_channel_weights: bool = False,
) -> Dict[str, Any]:
    """Fold observers into the int8 export (CPU tensors)."""
    qcfg = cfg.quant or default_qat_qconfig()
    p = {k: v.detach().cpu() for k, v in params.items()}
    s = {k: v.detach().cpu() for k, v in quant_stats.items()}

    def dense(name):
        return dense_int8(p[f"{name}.weight"].T, p.get(f"{name}.bias"), _stats(s, name), qcfg,
                          per_channel=per_channel_weights)

    def ln(name):
        return ln_params(p[f"{name}.ln.weight"], p[f"{name}.ln.bias"], _stats(s, name), qcfg)

    if not (cfg.qat_wrapper and "input_fq.min_val" in s):
        raise ValueError("int8 conversion requires the input QuantStub observer "
                         "(train with qat_wrapper=True, as the reference does)")
    out: Dict[str, Any] = {
        "cls_token": p["cls_token"].to(torch.float32),
        "pos_embed": p["pos_embed"].to(torch.float32),
        "patch_embed": dense("patch_embed.proj"),
        "norm": ln("norm"),
        "input_q": act_qparams(s["input_fq.min_val"], s["input_fq.max_val"], qcfg),
    }
    # feature mode (num_classes=0, detection towers): no head; the final-LN
    # qparams stay, for the dequantized token stream
    if cfg.num_classes:
        out["head"] = dense("head")
    if cfg.pre_norm:
        out["norm_pre"] = ln("norm_pre")
    blocks = {}
    for i in range(cfg.depth):
        b = f"blocks.{i}"
        fc1 = _stats(s, f"{b}.mlp.fc1")["act_fq"]
        blocks[str(i)] = {
            "norm1": ln(f"{b}.norm1"),
            "qkv": dense(f"{b}.attn.qkv"),
            "proj": dense(f"{b}.attn.proj"),
            "norm2": ln(f"{b}.norm2"),
            "fc1": dense(f"{b}.mlp.fc1"),
            "gelu_q": act_output_qparams(fc1["min_val"], fc1["max_val"], qcfg, act=cfg.act),
            "fc2": dense(f"{b}.mlp.fc2"),
        }
    out["blocks"] = blocks
    return out


def export_to_device(qp: Any, device) -> Any:
    """The export with every tensor of rank >= 1 on ``device``; 0-d qparams
    stay on the host."""
    if isinstance(qp, dict):
        return {k: export_to_device(v, device) for k, v in qp.items()}
    if isinstance(qp, torch.Tensor) and qp.ndim > 0:
        return qp.to(device)
    return qp


def _head_or_tokens(qp, zq, cfg: ViTConfig, dense) -> torch.Tensor:
    """The serving epilogue over the final-LN int8 stream ``zq``: the head
    GEMM on the cls row → f32 logits; in feature mode (``num_classes=0``)
    the dequantized ``[B, N, D]`` tokens, ``(q_u8 − zp)·s`` in f32."""
    nq = qp["norm"]["out_q"]
    if cfg.num_classes == 0:
        return (zq.to(torch.float32) + (128.0 - f32(nq["zero_point"]))) * f32(nq["scale"])
    return dense(zq[:, 0].contiguous(), qp["head"], nq, out_dtype=torch.float32)


def _embed(qp, images, cfg: ViTConfig, cdt, dense) -> torch.Tensor:
    """Patch-embed GEMM, cls token and position embedding in ``cdt``, then
    the pre-encoder LayerNorm where the model has one."""
    patches = extract_patches(images.to(torch.float32), cfg.patch_size)
    iq = qp["input_q"]
    x_q = quantize_act_shifted(patches, iq["scale"], iq["zero_point"], iq.get("quant_max", 255.0))
    x = dense(x_q, qp["patch_embed"], iq, out_dtype=cdt)
    b = x.shape[0]
    cls = qp["cls_token"].to(device=x.device, dtype=cdt).expand(b, 1, cfg.embed_dim)
    x = torch.cat([cls, x], dim=1) + qp["pos_embed"].to(device=x.device, dtype=cdt)
    if cfg.pre_norm:
        npre = qp["norm_pre"]
        x = layernorm_f32(x, npre["scale"], npre["bias"], cfg.layer_norm_eps).to(cdt)
    return x


@torch.no_grad()
def int8_apply(
    qp: Dict[str, Any],
    images: torch.Tensor,  # [B, H, W, 3] preprocessed (normalized f32)
    cfg: ViTConfig,
    *,
    attn_dtype=torch.float32,
    compute_dtype=torch.float32,
    gelu_approx: bool = False,
    attn_impl: str = "xla",  # exact path: "xla" | "pallas_long"
    fused: str = "none",
) -> torch.Tensor:
    """Int8 serving forward → [B, num_classes] f32 logits; in feature mode
    the dequantized final-LN tokens [B, N, D] (f32).

    ``fused``: ``"none"`` (the exact path), ``"megamodel"`` (K4's chain),
    ``"megablock_long[:TQ[:RC[:flags]]]"`` / ``"megamodel_long[...]"``
    (K6's chain), each with a ``*_plain`` twin that runs the same chain
    through the kernels' plain versions. ``attn_impl="pallas_long"`` runs
    the exact path's attention through the long attention kernel (K5a)."""
    if fused != "none":
        kind, plain = _parse_fused(fused)
        return _fused_stack(qp, images, cfg, kind, compute_dtype=compute_dtype, plain=plain)
    if attn_impl not in ("xla", "pallas_long"):
        raise ValueError(f"unknown attn_impl {attn_impl!r}; expected 'xla' or 'pallas_long'")
    h_heads, hd, eps, cdt = cfg.num_heads, cfg.head_dim, cfg.layer_norm_eps, compute_dtype
    x = _embed(qp, images, cfg, cdt, int8_dense_plain)

    def qd(y, layer, in_q):
        return quantized_dense(y, layer, in_q, out_dtype=cdt)

    def ln(y, p):
        return layernorm_f32(y, p["scale"], p["bias"], eps).to(cdt)

    def attention(qkv):
        if attn_impl == "pallas_long":
            return long_attention_qkv(qkv.to(attn_dtype).contiguous(), h_heads, hd).to(cdt)
        return xla_attention_qkv(qkv.to(attn_dtype), h_heads, hd, softmax_dtype=attn_dtype).to(cdt)

    for i in range(cfg.depth):
        blk = qp["blocks"][str(i)]
        qkv = qd(ln(x, blk["norm1"]), blk["qkv"], blk["norm1"]["out_q"])
        # proj input bounded by the qkv output range (convex combination of v)
        x = x + qd(attention(qkv), blk["proj"], blk["qkv"]["out_q"])
        f = qd(ln(x, blk["norm2"]), blk["fc1"], blk["norm2"]["out_q"])
        if cfg.act == "quick_gelu":
            f32v = f.to(torch.float32)
            f = (f32v * torch.sigmoid(1.702 * f32v)).to(cdt)
        elif gelu_approx:
            f = torch.nn.functional.gelu(f, approximate="tanh")
        else:
            f = torch.nn.functional.gelu(f.to(torch.float32)).to(cdt)
        x = x + qd(f, blk["fc2"], blk["gelu_q"])
    if cfg.num_classes:
        x = x[:, :1]  # only the cls row feeds the head; LN is per token
    nq = qp["norm"]["out_q"]
    zq = quantize_act_shifted(layernorm_f32(x, qp["norm"]["scale"], qp["norm"]["bias"], eps),
                              nq["scale"], nq["zero_point"], nq.get("quant_max", 255.0))
    return _head_or_tokens(qp, zq, cfg, int8_dense_plain)


_FUSED_KINDS = ("megamodel", "megablock_long", "megamodel_long")


def _parse_fused(fused: str):
    """``fused`` → (kind, plain). The long modes take the TPU's options
    ``:TQ:RC:flags``: q_tile, row_chunk and the scheduling flags ``suN``,
    ``cuN``, ``bbN`` are accepted and change nothing here (on the TPU they
    are bit-identical scheduling knobs); ``i8`` (int8 score dots) is not
    ported."""
    base, *opts = fused.split(":")
    plain = base.endswith("_plain")
    kind = base[: -len("_plain")] if plain else base
    if kind not in _FUSED_KINDS or (kind == "megamodel" and opts):
        raise ValueError(f"unknown fused mode {fused!r}; expected 'none', 'megamodel', "
                         "'megablock_long[:TQ[:RC[:flags]]]' or 'megamodel_long[...]', "
                         "or a '*_plain' twin")
    for i, opt in enumerate(opts):
        if i < 2:
            if opt and not opt.isdigit():
                raise ValueError(f"{fused!r}: q_tile / row_chunk must be integers")
        elif opt == "i8":
            raise NotImplementedError(
                "the i8 (int8 score dot) option of K6 is not ported: ROADMAP.md Queue 2")
        elif not (opt[:2] in ("su", "cu", "bb") and opt[2:].isdigit()):
            raise ValueError(f"{fused!r}: unknown flag {opt!r}")
    return kind, plain


def _fused_stack(qp, images, cfg: ViTConfig, kind: str, *, compute_dtype, plain: bool):
    """K4 (``megamodel``) or K6 (``mega{block,model}_long``) on Hopper: the
    entry LN → int8 (ln_quantize), the per-block launch chain, then the head
    GEMM on the cls row or, in feature mode, the dequantized tokens."""
    long = kind != "megamodel"
    if not long and cfg.act != "gelu":
        raise NotImplementedError(
            f"the megamodel chain computes tanh-GELU in-kernel (act={cfg.act!r}); "
            "short quick-GELU serving needs K3 behind the mixed_none chain: ROADMAP.md Queue 2"
        )
    if cfg.act not in ("gelu", "quick_gelu"):
        raise NotImplementedError(f"{kind} computes the activation in-kernel; act={cfg.act!r} "
                                  "models need the exact path")
    if long:
        ops = LONG_PLAIN_OPS if plain else LONG_KERNEL_OPS
    else:
        ops = PLAIN_OPS if plain else KERNEL_OPS
    eps = cfg.layer_norm_eps
    qmax = float(cfg.quant.activation.quant_max) if cfg.quant else 255.0
    x = _embed(qp, images, cfg, compute_dtype, ops.int8_dense)
    n = x.shape[1]
    blk0 = qp["blocks"]["0"]
    zq = ops.ln_quantize(x, blk0["norm1"], blk0["norm1"]["out_q"], eps=eps, quant_max=qmax)
    kw = dict(num_heads=cfg.num_heads, head_dim=cfg.head_dim, act=cfg.act, eps=eps, n_valid=n,
              quant_max=qmax, ops=ops)
    if kind == "megablock_long":
        for i in range(cfg.depth):
            nxt = qp["blocks"][str(i + 1)]["norm1"] if i + 1 < cfg.depth else qp["norm"]
            x, zq = long_block_forward(zq, x, qp["blocks"][str(i)], nxt, **kw)
    else:
        stack = long_model_forward if long else model_forward
        _, zq = stack(zq, x, qp["blocks"], qp["norm"], depth=cfg.depth, **kw)
    return _head_or_tokens(qp, zq, cfg, ops.int8_dense)


# the long rung serves sequences of at least this many tokens (OWLv2's 2,305)
LONG_SEQ_MIN = 1536


def _preset_kernel_opts(cfg: ViTConfig) -> Dict[str, Any]:
    """Kernel-path selection on CUDA, gated on what the Hopper kernels accept:
    the megamodel chain (K4) for GELU models within attention_q's gate, the
    megamodel_long chain (K6) for GELU or quick-GELU models of >= 1536 tokens
    within the long attention kernel's plan. Geometries they do not cover
    raise: the card never quietly runs the plain path."""
    d, p, hd, n = cfg.embed_dim, cfg.patch_size, cfg.head_dim, cfg.seq_len
    ok = (gemm_shapes_ok(p * p * 3, d) and gemm_shapes_ok(d, 3 * d)
          and gemm_shapes_ok(d, d, resid_ln=True) and gemm_shapes_ok(d, cfg.mlp_dim)
          and gemm_shapes_ok(cfg.mlp_dim, d, resid_ln=True))
    if not ok:
        raise NotImplementedError(
            f"embed_dim {d} / mlp_dim {cfg.mlp_dim} / patch {p} outside the int8_gemm "
            "kernel's gate (K a multiple of 64): ROADMAP.md Queue 2, K2"
        )
    if cfg.act == "gelu" and attention_shapes_ok(n, hd):
        return {"fused": "megamodel"}
    if (cfg.act in ("gelu", "quick_gelu") and n >= LONG_SEQ_MIN
            and long_megablock_shapes_ok(n, cfg.num_heads, hd, cfg.mlp_dim)):
        return {"fused": "megamodel_long"}
    raise NotImplementedError(
        f"no Hopper serving path for act={cfg.act!r} at seq_len {n}, head_dim {hd}: megamodel "
        "takes GELU models within attention_q's gate, megamodel_long sequences of >= "
        f"{LONG_SEQ_MIN} tokens within the long attention kernel's plan; short quick-GELU "
        "models need K3 behind the mixed_none chain (ROADMAP.md Queue 2)"
    )


def serving_preset(cfg: ViTConfig, device) -> Dict[str, Any]:
    """Serving options for ``device``: ``{}`` (the exact defaults) off CUDA;
    on CUDA a kernel chain (:func:`_preset_kernel_opts`) with a bf16 stream
    and tanh-GELU (quick-GELU models keep their exact activation)."""
    if torch.device(device).type != "cuda":
        return {}
    opts: Dict[str, Any] = {
        "attn_dtype": torch.bfloat16,
        "compute_dtype": torch.bfloat16,
        "gelu_approx": True,
    }
    opts.update(_preset_kernel_opts(cfg))
    return opts


def make_int8_forward(cfg: ViTConfig, **opts):
    """Serving closure: (export, normalized images) → logits (or tokens)."""

    def fwd(qp, images):
        return int8_apply(qp, images, cfg, **opts)

    return fwd
