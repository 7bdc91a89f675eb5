"""True-int8 ViT inference: convert + the serving forward (port of
``qat_vit_tpu/serve/int8_vit.py``).

- :func:`convert_vit`: float params + observer stats → the int8 export, the
  same nested dict as the JAX package's (``str(i)`` block keys,
  ``w_int8 [K, N]``, ``w_colsum``, ``w_scale``, ``bias``, ``out_q``), as CPU
  tensors. :func:`export_to_device` moves it to a device, leaving the 0-d
  qparams on the host so the kernels' scalar arguments cost no device sync.
- :func:`int8_apply`: every option of the JAX package's. ``fused="none"``
  is the exact path (f32 stream, erf-GELU, quantize by division,
  float64-exact int GEMMs); ``use_pallas=True`` puts its GEMMs on K7
  (``ops/pallas_gemm.py``) and ``attn_impl`` its attention on K8
  (``"pallas"``), kernel A (``"pallas_fused"``) or K5a (``"pallas_long"``).
  ``fused="pallas"`` / ``"mixed*"`` are the per-GEMM chains;
  ``"megamodel"`` is K4's block chain through the CUDA kernels
  (``ops/block_kernel.py``), ``"megablock"`` / ``"megamodel_res"`` the
  same blocks as one cooperative launch per block (K9a) or per forward
  (K9b), ``"megamodel_long"`` / ``"megablock_long"`` K6's chain
  (``ops/long_block_kernel.py``; with the ``i8`` flag its int8 score
  dots); the patch-embed and head GEMMs run on the
  ``int8_gemm`` kernel too. Each ``*_plain`` twin runs that same path
  through the kernels' plain versions (the card's reference for them).
  Feature-mode towers (``num_classes=0``) return the dequantized final-LN
  tokens.
- :func:`serving_preset`: ``{}`` on the CPU; on CUDA, in bf16 with
  tanh-GELU (or the model's quick-GELU), JAX's rung on JAX's conditions
  where the Hopper kernels take the geometry (:func:`_preset_kernel_opts`),
  or, as in JAX, the exact path in bf16 where no kernel gate of either
  package does.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Dict, Optional, Tuple, Union

import torch

from qat_vit_tpu_torch.models.vit import ViTConfig, extract_patches
from qat_vit_tpu_torch.ops.block_kernel import (
    KERNEL_OPS,
    PLAIN_OPS,
    megablock_forward,
    megablock_forward_plain,
    model_forward,
)
from qat_vit_tpu_torch.ops.flash_attention import (
    attention_fwd,
    attention_fwd_plain,
    flash_attention_qkv,
    flash_attention_qkv_plain,
    xla_attention_qkv,
)
from qat_vit_tpu_torch.ops.fused_serve import (
    gemm_shapes_ok,
    int8_dense_plain,
    layernorm_f32,
    with_packed_weight,
)
from qat_vit_tpu_torch.ops.long_attention import (
    long_attention_qkv,
    long_attention_qkv_plain,
    long_attention_stream_ok,
)
from qat_vit_tpu_torch.ops.long_block_kernel import (
    LONG_KERNEL_OPS,
    LONG_PLAIN_OPS,
    long_block_forward,
    long_megablock_shapes_ok,
    long_model_forward,
)
from qat_vit_tpu_torch.ops.pallas_gemm import fused_quantize_matmul_available
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
    stay on the host. On a CUDA device every GEMM layer is also packed
    (:func:`pack_gemm_weights`), the one place the port packs them."""
    out = _to_device(qp, device)
    return pack_gemm_weights(out) if torch.device(device).type == "cuda" else out


def _to_device(qp: Any, device) -> Any:
    if isinstance(qp, dict):
        return {k: _to_device(v, device) for k, v in qp.items()}
    if isinstance(qp, torch.Tensor) and qp.ndim > 0:
        return qp.to(device)
    return qp


def pack_gemm_weights(qp: Any) -> Any:
    """The export (a tower, or a tree holding towers) with every GEMM layer
    (each dict holding ``w_int8``: the blocks' qkv, proj, fc1 and fc2, the
    patch embedding and the head) given ``w_int8_t``, its weight packed
    k-contiguous (``fused_serve.with_packed_weight``), which the int8_gemm
    kernels, K7 and K9 read; the JAX-layout ``w_int8`` stays for every
    other reader (the plain versions, the file format)."""
    if not isinstance(qp, dict):
        return qp
    out = {k: pack_gemm_weights(v) for k, v in qp.items()}
    return with_packed_weight(out) if "w_int8" in out else out


def _head_or_tokens(qp, zq, cfg: ViTConfig, dense) -> torch.Tensor:
    """The serving epilogue over the final-LN int8 stream ``zq``: the head
    GEMM on the cls row → f32 logits; in feature mode (``num_classes=0``)
    the dequantized ``[B, N, D]`` tokens, ``(q_u8 − zp)·s`` in f32."""
    nq = qp["norm"]["out_q"]
    if cfg.num_classes == 0:
        return (zq.to(torch.float32) + (128.0 - f32(nq["zero_point"]))) * f32(nq["scale"])
    return dense(zq[:, 0].contiguous(), qp["head"], nq, out_dtype=torch.float32)


def _embed(qp, images, cfg: ViTConfig, cdt, dense, use_pallas=None) -> torch.Tensor:
    """Patch-embed GEMM (``dense`` after the dividing quantize, or K7 where
    ``use_pallas`` and its gate say so), cls token and position embedding in
    ``cdt``, then the pre-encoder LayerNorm where the model has one."""
    patches = extract_patches(images.to(torch.float32), cfg.patch_size)
    iq = qp["input_q"]
    k, d = qp["patch_embed"]["w_int8"].shape
    if use_pallas and fused_quantize_matmul_available(patches.shape, (k, d)):
        x = quantized_dense(patches, qp["patch_embed"], iq, use_pallas=True, out_dtype=cdt)
    else:
        x_q = quantize_act_shifted(patches, iq["scale"], iq["zero_point"],
                                   iq.get("quant_max", 255.0))
        # JAX computes the patch embedding in XLA on every path: a K = 3 p^2
        # that int8_gemm does not take (p = 14: 588) runs the plain int8 product
        x = (dense if gemm_shapes_ok(k, d) else int8_dense_plain)(x_q, qp["patch_embed"], iq,
                                                                  out_dtype=cdt)
    b = x.shape[0]
    cls = qp["cls_token"].to(device=x.device, dtype=cdt).expand(b, 1, cfg.embed_dim)
    x = torch.cat([cls, x], dim=1) + qp["pos_embed"].to(device=x.device, dtype=cdt)
    if cfg.pre_norm:
        npre = qp["norm_pre"]
        x = layernorm_f32(x, npre["scale"], npre["bias"], cfg.layer_norm_eps).to(cdt)
    return x


ATTN_IMPLS = ("xla", "pallas", "pallas_fused", "pallas_long")


def _float_attention(attn_impl: str, plain: bool, attn_dtype):
    """``attn_impl`` → ``fn(qkv, heads, hd)``, the attention in the qkv
    dtype: K8 (``pallas``), kernel A (``pallas_fused`` without ``out_q``),
    K5a (``pallas_long``), or the plain einsum (``xla``); with ``plain``
    the kernels' plain versions."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attn_impl {attn_impl!r}; expected one of {ATTN_IMPLS}")
    if attn_impl == "pallas":
        return flash_attention_qkv_plain if plain else flash_attention_qkv
    if attn_impl == "pallas_fused":
        return attention_fwd_plain if plain else attention_fwd
    if attn_impl == "pallas_long":
        fn = long_attention_qkv_plain if plain else long_attention_qkv
        return lambda qkv, h, hd: fn(qkv.contiguous(), h, hd)
    return lambda qkv, h, hd: xla_attention_qkv(qkv, h, hd, softmax_dtype=attn_dtype)


@torch.no_grad()
def int8_apply(
    qp: Dict[str, Any],
    images: torch.Tensor,  # [B, H, W, 3] preprocessed (normalized f32)
    cfg: ViTConfig,
    *,
    attn_dtype=torch.float32,
    compute_dtype=torch.float32,
    use_pallas: Optional[bool] = None,
    attn_impl: str = "xla",
    gelu_approx: bool = False,
    fused: Union[str, bool] = "none",
) -> torch.Tensor:
    """Int8 serving forward → [B, num_classes] f32 logits; in feature mode
    the dequantized final-LN tokens [B, N, D] (f32).

    ``fused``: ``"none"`` / ``False`` (the exact path), ``True`` (=
    ``"pallas"``), ``"pallas"`` / ``"mixed"`` / ``"mixed_qkv"`` /
    ``"mixed_fc1"`` / ``"mixed_none"`` (the chains of
    :func:`_fused_blocks`), ``"megamodel[:BB[:tight]]"`` (K4's chain),
    ``"megablock[:BB[:tight]]"`` (K9a, one launch per block),
    ``"megamodel_res[:BB[:tight]]"`` (K9b, one launch per forward),
    ``"megablock_long[:TQ[:RC[:flags]]]"`` / ``"megamodel_long[...]"`` (K6's
    chain); each with a ``*_plain`` twin that runs the same path through
    the kernels' plain versions.

    ``use_pallas`` puts the GEMMs of the exact path, and the patch embed of
    every path, on K7 where its shape gate admits them. ``attn_impl``
    (``"xla"``, ``"pallas"`` = K8, ``"pallas_fused"`` = kernel A / K3,
    ``"pallas_long"`` = K5a) picks the attention of the exact path and of
    the ``pallas`` / ``mixed*`` chains."""
    parsed = _parse_fused(fused)
    if parsed is not None:
        kind, plain, int8_scores = parsed
        if kind in _MODES:
            return _fused_blocks(qp, images, cfg, kind, plain=plain, attn_dtype=attn_dtype,
                                 compute_dtype=compute_dtype, attn_impl=attn_impl,
                                 use_pallas=use_pallas)
        return _fused_stack(qp, images, cfg, kind, compute_dtype=compute_dtype, plain=plain,
                            use_pallas=use_pallas, int8_scores=int8_scores)
    attention_f = _float_attention(attn_impl, False, attn_dtype)
    h_heads, hd, eps, cdt = cfg.num_heads, cfg.head_dim, cfg.layer_norm_eps, compute_dtype
    x = _embed(qp, images, cfg, cdt, int8_dense_plain, use_pallas)

    def qd(y, layer, in_q):
        return quantized_dense(y, layer, in_q, use_pallas=use_pallas, out_dtype=cdt)

    def ln(y, p):
        return layernorm_f32(y, p["scale"], p["bias"], eps).to(cdt)

    for i in range(cfg.depth):
        blk = qp["blocks"][str(i)]
        qkv = qd(ln(x, blk["norm1"]), blk["qkv"], blk["norm1"]["out_q"])
        # proj input bounded by the qkv output range (convex combination of v)
        x = x + qd(attention_f(qkv.to(attn_dtype), h_heads, hd).to(cdt), blk["proj"],
                   blk["qkv"]["out_q"])
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
    zq = _ln_quantize_divide(x, qp["norm"], nq, eps)
    return _head_or_tokens(qp, zq, cfg, int8_dense_plain)


def _ln_quantize_divide(y, ln, out_q, eps) -> torch.Tensor:
    """LN (f32) → int8 by division: the exact path's seam, and the JAX
    package's ``_ln_quantize_xla`` in the mixed chains."""
    return quantize_act_shifted(layernorm_f32(y, ln["scale"], ln["bias"], eps),
                                out_q["scale"], out_q["zero_point"], out_q.get("quant_max", 255.0))


# the per-GEMM chains (JAX _fused_blocks), K4's chain and K9, K6's chain
_MODES = ("pallas", "mixed", "mixed_qkv", "mixed_fc1", "mixed_none")
_MEGA_KINDS = ("megamodel", "megablock", "megamodel_res")
_LONG_KINDS = ("megablock_long", "megamodel_long")


def _parse_fused(fused: Union[str, bool, None]) -> Optional[Tuple[str, bool, bool]]:
    """``fused`` → None (the exact path) or (kind, plain, int8_scores).
    ``True`` is ``"pallas"``; ``False``, ``None``, ``""`` and ``"none"`` the
    exact path, as in the JAX package. ``megamodel`` / ``megablock`` /
    ``megamodel_res`` take the TPU's ``:BB[:tight]`` (images per grid step,
    sequence padded to 32 instead of 128): accepted and changing nothing
    here, since the kernels take the unpadded sequence and padded keys would
    get exactly zero probability, so the valid rows are the same bits either
    way. The long modes take ``:TQ:RC:flags``: q_tile, row_chunk and the
    scheduling flags ``suN``, ``cuN``, ``bbN`` are accepted and change
    nothing here (on the TPU they are bit-identical scheduling knobs);
    ``i8`` turns on the int8 score dots."""
    if fused is True:
        fused = "pallas"
    if fused is False or fused is None or fused in ("", "none"):
        return None
    base, *opts = fused.split(":")
    plain = base.endswith("_plain")
    kind = base[: -len("_plain")] if plain else base
    if kind in _MODES and not opts:
        return kind, plain, False
    if kind in _MEGA_KINDS:
        if (len(opts) > 2 or (opts and opts[0] and not opts[0].isdigit())
                or (len(opts) == 2 and opts[1] not in ("", "tight"))):
            raise ValueError(f"{fused!r}: expected '{kind}[:BLOCK_B[:tight]]'")
        return kind, plain, False
    if kind not in _LONG_KINDS:
        raise ValueError(f"unknown fused mode {fused!r}; expected 'none', one of {_MODES}, "
                         "'megamodel[:BB[:tight]]', 'megablock[...]', 'megamodel_res[...]', "
                         "'megablock_long[:TQ[:RC[:flags]]]' or 'megamodel_long[...]', "
                         "or a '*_plain' twin")
    for i, opt in enumerate(opts):
        if i < 2:
            if opt and not opt.isdigit():
                raise ValueError(f"{fused!r}: q_tile / row_chunk must be integers")
        elif not (opt == "i8" or (opt[:2] in ("su", "cu", "bb") and opt[2:].isdigit())):
            raise ValueError(f"{fused!r}: unknown flag {opt!r}")
    return kind, plain, "i8" in opts[2:]


def _fused_blocks(qp, images, cfg: ViTConfig, mode: str, *, plain: bool, attn_dtype,
                  compute_dtype, attn_impl: str, use_pallas):
    """The JAX package's per-GEMM chains (``_fused_blocks``): activations
    cross op boundaries as int8.

    ``pallas``: every GEMM + epilogue on ``int8_gemm`` (qkv PLAIN; proj and
    fc2 RESID_LN_Q carrying the residual, the next LN and its quantize; fc1
    GELU_Q), the entry LN on ``ln_quantize``, the patch and head GEMMs on
    ``int8_gemm`` as in the megamodel chain. ``mixed``: the kernels only for
    qkv, proj and fc1 + GELU; ``mixed_qkv`` only qkv and proj,
    ``mixed_fc1`` only fc1, ``mixed_none`` none; what the JAX package runs
    in XLA (the other GEMMs, LN → quantize by division, GELU, the patch and
    head GEMMs) runs here as the exact path's plain PyTorch, so on the card
    the mixed chains spend their time in float64 GEMMs. ``attn_impl``:
    ``pallas_fused`` is K3 with the proj-input quantize in its epilogue;
    the others produce float attention (K8, K5a or the einsum), quantized
    by division. With ``plain`` every kernel is its plain version."""
    eps, cdt = cfg.layer_norm_eps, compute_dtype
    qmax = float(cfg.quant.activation.quant_max) if cfg.quant else 255.0
    mixed = mode.startswith("mixed")
    pallas_qkv = mode in ("mixed", "mixed_qkv")
    pallas_fc1 = mode in ("mixed", "mixed_fc1")
    if cfg.act not in ("gelu", "quick_gelu") and (pallas_fc1 or not mixed):
        raise NotImplementedError(
            f"fused mode {mode!r} computes the activation in-kernel; act={cfg.act!r} models "
            "need 'mixed_none'/'mixed_qkv' (or the exact path)")
    ops = PLAIN_OPS if plain else KERNEL_OPS
    attention_f = _float_attention(attn_impl, plain, attn_dtype)
    h_heads, hd = cfg.num_heads, cfg.head_dim

    def xla_dense(x_q, layer, in_q, out_dtype=cdt):
        return int8_dense_plain(x_q, layer, in_q, out_dtype=out_dtype)

    outer = xla_dense if mixed else ops.int8_dense  # patch embed and head
    x = _embed(qp, images, cfg, cdt, outer, use_pallas)
    blk0 = qp["blocks"]["0"]
    if mixed:
        zq = _ln_quantize_divide(x, blk0["norm1"], blk0["norm1"]["out_q"], eps)
    else:
        zq = ops.ln_quantize(x, blk0["norm1"], blk0["norm1"]["out_q"], eps=eps, quant_max=qmax)
    for i in range(cfg.depth):
        blk = qp["blocks"][str(i)]
        oq, n2q = blk["qkv"]["out_q"], blk["norm2"]["out_q"]
        if mixed and not pallas_qkv:
            qkv = xla_dense(zq, blk["qkv"], blk["norm1"]["out_q"])
        else:
            qkv = ops.int8_dense(zq, blk["qkv"], blk["norm1"]["out_q"], out_dtype=cdt)
        # proj input bounded by the qkv output range (convex combination of v)
        if attn_impl == "pallas_fused":
            o_q = ops.attention(qkv.to(attn_dtype), h_heads, hd, out_q=oq, quant_max=qmax)
        else:
            o = attention_f(qkv.to(attn_dtype), h_heads, hd).to(cdt)
            o_q = quantize_act_shifted(o, oq["scale"], oq["zero_point"], oq.get("quant_max", 255.0))
        nxt = qp["blocks"][str(i + 1)]["norm1"] if i + 1 < cfg.depth else qp["norm"]
        if not mixed:
            x, zq2 = ops.int8_dense_resid_ln_q(o_q, blk["proj"], oq, x, blk["norm2"], n2q,
                                               eps=eps, out_dtype=cdt, quant_max=qmax)
            g_q = ops.int8_dense_gelu_q(zq2, blk["fc1"], n2q, blk["gelu_q"], act=cfg.act,
                                        quant_max=qmax)
            # the fc2 epilogue carries the NEXT LayerNorm and its quantize
            x, zq = ops.int8_dense_resid_ln_q(g_q, blk["fc2"], blk["gelu_q"], x, nxt,
                                              nxt["out_q"], eps=eps, out_dtype=cdt,
                                              quant_max=qmax)
            continue
        if pallas_qkv:
            p = ops.int8_dense(o_q, blk["proj"], oq, out_dtype=cdt)
        else:
            p = xla_dense(o_q, blk["proj"], oq)
        x = x + p
        zq2 = _ln_quantize_divide(x, blk["norm2"], n2q, eps)
        if pallas_fc1:
            g_q = ops.int8_dense_gelu_q(zq2, blk["fc1"], n2q, blk["gelu_q"], act=cfg.act,
                                        quant_max=qmax)
        else:
            f1 = xla_dense(zq2, blk["fc1"], n2q)
            if cfg.act == "quick_gelu":
                f32v = f1.to(torch.float32)
                g = (f32v * torch.sigmoid(1.702 * f32v)).to(f1.dtype)
            else:
                g = torch.nn.functional.gelu(f1, approximate="tanh")
            gq = blk["gelu_q"]
            g_q = quantize_act_shifted(g, gq["scale"], gq["zero_point"], gq.get("quant_max", 255.0))
        x = x + xla_dense(g_q, blk["fc2"], blk["gelu_q"])
        if i + 1 == cfg.depth and cfg.num_classes:
            x = x[:, :1]  # only the cls row feeds the head; LN is per token
        zq = _ln_quantize_divide(x, nxt, nxt["out_q"], eps)
    return _head_or_tokens(qp, zq, cfg, outer)


def _fused_stack(qp, images, cfg: ViTConfig, kind: str, *, compute_dtype, plain: bool,
                 use_pallas=None, int8_scores: bool = False):
    """K4 (``megamodel``), K9a (``megablock``), K9b (``megamodel_res``) or K6
    (``mega{block,model}_long``, with ``int8_scores`` its int8 score dots)
    on Hopper: the entry LN → int8 (ln_quantize), the blocks, then the head
    GEMM on the cls row or, in feature mode, the dequantized tokens. The
    ``*_plain`` twins of K9a/K9b run K4's chain through the plain ops: their
    plain version."""
    long = kind in _LONG_KINDS
    if not long and cfg.act != "gelu":
        raise NotImplementedError(
            f"the {kind} kernels compute tanh-GELU in-kernel (act={cfg.act!r}); quick-GELU "
            "models take fused='mixed_none' (with attn_impl='pallas_fused'), as on the TPU"
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
    x = _embed(qp, images, cfg, compute_dtype, ops.int8_dense, use_pallas)
    n = x.shape[1]
    blk0 = qp["blocks"]["0"]
    zq = ops.ln_quantize(x, blk0["norm1"], blk0["norm1"]["out_q"], eps=eps, quant_max=qmax)
    kw = dict(num_heads=cfg.num_heads, head_dim=cfg.head_dim, eps=eps, n_valid=n,
              quant_max=qmax)
    if kind in ("megablock", "megablock_long"):
        if kind == "megablock_long":
            block = partial(long_block_forward, act=cfg.act, ops=ops, int8_scores=int8_scores)
        else:
            block = megablock_forward_plain if plain else megablock_forward
        for i in range(cfg.depth):
            nxt = qp["blocks"][str(i + 1)]["norm1"] if i + 1 < cfg.depth else qp["norm"]
            x, zq = block(zq, x, qp["blocks"][str(i)], nxt, **kw)
    elif long:
        _, zq = long_model_forward(zq, x, qp["blocks"], qp["norm"], depth=cfg.depth,
                                   act=cfg.act, ops=ops, int8_scores=int8_scores, **kw)
    else:
        _, zq = model_forward(zq, x, qp["blocks"], qp["norm"], depth=cfg.depth, act=cfg.act,
                              ops=ops, resident=kind == "megamodel_res", **kw)
    return _head_or_tokens(qp, zq, cfg, ops.int8_dense)


# the long rung serves sequences of at least this many tokens (OWLv2's 2,305)
LONG_SEQ_MIN = 1536
# JAX's rung 3 (qat_vit_tpu/serve/int8_vit.py): the whole-model long kernel
# at q_tile 512 and row chunk 256 (sequence padded to 512), taken where its
# VMEM estimate at stripe unroll 1 stays within the kernels' 100 MiB
JAX_LONG_Q_TILE, JAX_LONG_VMEM_LIMIT = 512, 100 * 1024 * 1024


def jax_long_rung_fits(n: int, d: int, mlp_dim: int) -> bool:
    """Whether JAX's preset can take its long rung (K6) at ``n`` tokens of
    width ``d``: ``long_megablock_pick_unroll`` finds a stripe unroll, i.e.
    ``long_megablock_vmem_bytes`` at unroll 1 (the packed qkv, f32 output
    and int8 q/k scratch, double-buffered activation tiles and weight
    panels, one f32 score stripe) is within its limit. Otherwise JAX falls
    to rung 4 (``mixed_none`` + the long attention), and so does the port,
    so that both serve a geometry through the same chain (the rungs differ
    in numerics: int8 attention output against bf16)."""
    n_pad = -(-n // JAX_LONG_Q_TILE) * JAX_LONG_Q_TILE
    scratch = n_pad * 3 * d * 2 + n_pad * d * 4 + n_pad * 2 * d
    acts = 2 * 2 * (n_pad * d + n_pad * d * 2)
    weights = 2 * (d * 3 * d + d * d + 2 * d * mlp_dim)
    return scratch + acts + weights + JAX_LONG_Q_TILE * n_pad * 4 <= JAX_LONG_VMEM_LIMIT


# JAX's slab kernels (its rungs 1 and 2; qat_vit_tpu/ops/_tiling.py): the
# packed width lane-aligned, head slabs tiling the 128-lane register, and
# block_b images of stacked f32 [n_pad, n_pad] scores within the VMEM budget
_JAX_LANE = 128
_JAX_SLAB_BLOCK_B, _JAX_SLAB_BUDGET = 4, 24 * 1024 * 1024


def _jax_slab_rung(cfg: ViTConfig) -> int:
    """JAX's preset rung on its slab kernels for ``cfg``: 1 (megamodel, GELU
    models whose scores fit with the sequence padded to 32), 2 (``mixed_none``
    + its fused attention, padded to 128), or 0 (neither):
    ``_tiling.shapes_ok`` and ``_tiling.batched_softmax_fits`` at block 4."""
    h, hd, n = cfg.num_heads, cfg.head_dim, cfg.seq_len
    if not (h * hd % _JAX_LANE == 0 and hd <= _JAX_LANE and _JAX_LANE % hd == 0):
        return 0
    for rung, pad in ((1, 32), (2, 128)):
        n_pad = -(-n // pad) * pad
        fits = _JAX_SLAB_BLOCK_B * h * n_pad * n_pad * 4 <= _JAX_SLAB_BUDGET
        if fits and (rung == 2 or cfg.act == "gelu"):
            return rung
    return 0


def _block_gemms_ok(d: int, mlp_dim: int) -> bool:
    """int8_gemm takes the four GEMMs of a block of width ``d``."""
    return (gemm_shapes_ok(d, 3 * d) and gemm_shapes_ok(d, d, resid_ln=True)
            and gemm_shapes_ok(d, mlp_dim) and gemm_shapes_ok(mlp_dim, d, resid_ln=True))


def _preset_kernel_opts(cfg: ViTConfig) -> Dict[str, Any]:
    """Kernel-path selection on CUDA: JAX's rungs on JAX's conditions, plus
    what the Hopper kernels themselves need (head dims a multiple of 8, the
    block GEMMs' K a multiple of 16):

    1. where JAX takes its megamodel rung (:func:`_jax_slab_rung`), the
       megamodel chain (K4: int8_gemm and K3, which takes any N);
    2. where JAX takes ``mixed_none`` + its fused attention: the same, K3
       (any activation; the GEMMs run plain);
    3. GELU or quick-GELU models of >= 1536 tokens whose block GEMMs
       int8_gemm takes, at a head dim the streaming attention takes, where
       JAX's own rung 3 fits (:func:`jax_long_rung_fits`): the
       megamodel_long chain (K6);
    4. models the streaming attention takes (hd a multiple of 8 and <= 128,
       any N): ``mixed_none`` + ``pallas_long`` (K5a);
    5. geometries none of them covers and no Pallas gate of the JAX
       package admits either: ``{}``, the exact path (its GEMMs and
       attention are plain PyTorch there, as they are XLA in JAX), which
       :func:`serving_preset` runs in bf16 with tanh-GELU, as JAX's does.

    The patch embedding is never a condition: JAX computes it in XLA, and
    ``_embed`` runs a K that int8_gemm does not take as the plain product.
    Where a Hopper need fails the port takes the next rung down, whose
    attention is still a kernel and whose GEMMs run plain: a block GEMM
    past int8_gemm's gate (K not a multiple of 16) at rung 1 gives rung 2,
    at rung 3 rung 4 (the named residues of the preset tests). A geometry
    that JAX serves on a slab kernel at a head dim below 8, which no Hopper
    attention takes, raises: the card never falls to the exact path where
    JAX runs a kernel. Like JAX's, it never emits ``i8``."""
    d, hd, n, mlp = cfg.embed_dim, cfg.head_dim, cfg.seq_len, cfg.mlp_dim
    slab = _jax_slab_rung(cfg)
    if slab and hd % 8 == 0:
        if slab == 1 and _block_gemms_ok(d, mlp):
            return {"fused": "megamodel"}
        return {"fused": "mixed_none", "attn_impl": "pallas_fused"}
    if (cfg.act in ("gelu", "quick_gelu") and n >= LONG_SEQ_MIN
            and long_megablock_shapes_ok(n, cfg.num_heads, hd, mlp)
            and jax_long_rung_fits(n, d, mlp)):
        return {"fused": "megamodel_long"}
    if long_attention_stream_ok(n, hd):
        return {"fused": "mixed_none", "attn_impl": "pallas_long"}
    if slab:
        raise NotImplementedError(
            f"{n} tokens at head_dim {hd}: the JAX package serves this geometry on its slab "
            "kernels, and no Hopper kernel's gate admits the head dim")
    return {}


def serving_preset(cfg: ViTConfig, device) -> Dict[str, Any]:
    """Serving options for ``device``: ``{}`` (the exact defaults) off CUDA;
    on CUDA a bf16 stream and tanh-GELU (quick-GELU models keep their exact
    activation) with the kernel chain of :func:`_preset_kernel_opts`, or the
    exact path where no kernel gate admits the geometry."""
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
