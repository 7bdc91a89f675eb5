"""Convert timm / HF torch ViT checkpoints into the JAX package's parameter
layout (port of ``qat_vit_tpu/models/torch_convert.py``).

Replaces the reference's reliance on ``timm.create_model`` + ``torch.load``
(teacher weights from HF ``edadaltocg/vit_base_patch16_224_in21k_ft_cifar10``,
reference src/models/model_registry.py:186-207). Keeps the reference's
defensive checkpoint handling: unwraps a nested ``state_dict`` key, strips the
DDP ``module.`` prefix, and drops QATWrapper ``quant./dequant.`` stub keys
(ref :196-204, :244-257) — the shapes a torch-side user's checkpoints come in.

Works on plain dicts of numpy arrays and returns the JAX package's trees
(``blocks_{i}``, dense ``kernel [in, out]``, LayerNorm ``scale``), which
``models/jax_params.py`` loads into the port's modules; a ``.pth`` is read
with ``torch.load(..., weights_only=True)``.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Mapping

import numpy as np

import torch

from qat_vit_tpu_torch.models.vit import ViTConfig

logger = logging.getLogger(__name__)


def as_numpy(v) -> np.ndarray:
    """A state dict value as numpy (a bf16 tensor, which numpy cannot hold, as f32)."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return np.asarray(v)


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Read a .pth/.bin checkpoint to numpy."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    state = normalize_state_dict_keys(obj)
    return {k: as_numpy(v) for k, v in state.items()}


def normalize_state_dict_keys(obj: Mapping[str, Any]) -> Dict[str, Any]:
    """Reference-compatible checkpoint tolerance (ref :196-204, :244-257):

    - unwrap nested ``{"state_dict": ...}`` / ``{"model": ...}``;
    - strip a leading ``module.`` (DDP) prefix;
    - drop ``quant.``/``dequant.`` stub keys and torch.ao fake-quant buffers
      (``*_fake_quant.*``, ``activation_post_process``) that a QAT-saved
      state dict carries.
    """
    state = dict(obj)
    for wrapper_key in ("state_dict", "model"):
        if wrapper_key in state and isinstance(state[wrapper_key], Mapping):
            state = dict(state[wrapper_key])
            break
    out: Dict[str, Any] = {}
    for k, v in state.items():
        if k.startswith("module."):
            k = k[len("module.") :]
        # QATWrapper inserts a `model.` level between stubs and the net.
        if k.startswith("model.") and not k.startswith("model.quant"):
            k = k[len("model.") :]
        if k.startswith(("quant.", "dequant.")):
            continue
        if "fake_quant" in k or "activation_post_process" in k:
            continue
        out[k] = v
    return out


def timm_vit_to_params(
    state: Mapping[str, np.ndarray], cfg: ViTConfig, strict: bool = True
) -> Dict[str, Any]:
    """Map a timm ``vit_*_patch16_224`` state dict to a VisionTransformer pytree.

    Layout notes:
    - torch Linear weight is [out, in] → transposed to [in, out] kernels;
    - the patch-embed Conv2d weight [D, C, kh, kw] becomes the conv-as-GEMM
      kernel with rows ordered (ph, pw, c) to match PatchEmbed's
      patch-flattening order (models/vit.py): permute to (kh, kw, C, D) then
      reshape to [kh*kw*C, D].
    """
    state = {k: as_numpy(v) for k, v in normalize_state_dict_keys(state).items()}
    used = set()

    def take(key: str) -> np.ndarray:
        used.add(key)
        return state[key]

    def dense(prefix: str) -> Dict[str, np.ndarray]:
        return {
            "kernel": take(f"{prefix}.weight").T.astype(np.float32),
            "bias": take(f"{prefix}.bias").astype(np.float32),
        }

    def ln(prefix: str) -> Dict[str, np.ndarray]:
        return {
            "ln": {
                "scale": take(f"{prefix}.weight").astype(np.float32),
                "bias": take(f"{prefix}.bias").astype(np.float32),
            }
        }

    D = cfg.embed_dim
    conv_w = take("patch_embed.proj.weight")  # [D, C, kh, kw]
    assert conv_w.shape == (D, 3, cfg.patch_size, cfg.patch_size), conv_w.shape
    kernel = conv_w.transpose(2, 3, 1, 0).reshape(-1, D).astype(np.float32)
    params: Dict[str, Any] = {
        "patch_embed": {
            "proj": {
                "kernel": kernel,
                "bias": take("patch_embed.proj.bias").astype(np.float32),
            }
        },
        "cls_token": take("cls_token").astype(np.float32),
        "pos_embed": take("pos_embed").astype(np.float32),
        "norm": ln("norm"),
        "head": dense("head"),
    }
    for i in range(cfg.depth):
        b = f"blocks.{i}"
        params[f"blocks_{i}"] = {
            "norm1": ln(f"{b}.norm1"),
            "attn": {
                "qkv": dense(f"{b}.attn.qkv"),
                "proj": dense(f"{b}.attn.proj"),
            },
            "norm2": ln(f"{b}.norm2"),
            "mlp": {
                "fc1": dense(f"{b}.mlp.fc1"),
                "fc2": dense(f"{b}.mlp.fc2"),
            },
        }
    unused = set(state) - used
    if unused:
        msg = f"unused checkpoint keys: {sorted(unused)[:8]}{'...' if len(unused) > 8 else ''}"
        if strict:
            raise ValueError(msg)
        logger.warning(msg)
    return params


def owlv2_vision_to_params(
    state: Mapping[str, np.ndarray], cfg: ViTConfig, strict: bool = True
) -> Dict[str, Any]:
    """Map an HF ``Owlv2VisionModel``/``CLIPVisionModel`` state dict to a
    VisionTransformer pytree (``pre_norm=True, act="quick_gelu",
    patch_bias=False`` — see models/owlv2.py:owlv2_vision_vit_kwargs).

    This is the weight path for the reference's OWLv2 teacher
    (``google/owlv2-base-patch16-ensemble``, ref model_registry.py:269-279)
    once a local checkpoint exists. Layout notes beyond the timm mapping:

    - keys may carry an ``owlv2.``/``vision_model.`` prefix (full detection
      model vs bare tower) — both are stripped;
    - CLIP spells the pre-encoder LN ``pre_layrnorm`` (an upstream typo),
      OWLv2 spells it ``pre_layernorm`` — both accepted;
    - separate q/k/v projections are packed into our fused qkv kernel with
      column order q|k|v (models/vit.py reshapes [B,N,3D] -> [B,N,3,h,hd]);
    - ``class_embedding`` [D] -> cls_token [1,1,D];
      ``position_embedding.weight`` [N+1,D] -> pos_embed [1,N+1,D];
    - the classifier ``head`` has no HF counterpart and is NOT returned —
      merge the converted tree over an initialized template (the trainer's
      tolerant loader does this) or install a head explicitly.
    """
    norm = {}
    for k, v in normalize_state_dict_keys(state).items():
        if k.startswith("owlv2."):  # full Owlv2ForObjectDetection checkpoint
            k = k[len("owlv2.") :]
        if k.startswith("vision_model."):
            k = k[len("vision_model.") :]
        elif "text_model" in k or k.split(".")[0] in (
            "class_head", "box_head", "objectness_head", "logit_scale",
            "logit_shift", "layer_norm", "visual_projection",
            "text_projection",
        ):
            continue  # detection/text parts: not part of the vision tower
        norm[k] = as_numpy(v)
    state = norm
    used = set()

    def take(key: str) -> np.ndarray:
        used.add(key)
        return state[key]

    def dense(prefix: str) -> Dict[str, np.ndarray]:
        return {
            "kernel": take(f"{prefix}.weight").T.astype(np.float32),
            "bias": take(f"{prefix}.bias").astype(np.float32),
        }

    def ln(prefix: str) -> Dict[str, np.ndarray]:
        return {
            "ln": {
                "scale": take(f"{prefix}.weight").astype(np.float32),
                "bias": take(f"{prefix}.bias").astype(np.float32),
            }
        }

    D = cfg.embed_dim
    conv_w = take("embeddings.patch_embedding.weight")  # [D, C, p, p], no bias
    assert conv_w.shape == (D, 3, cfg.patch_size, cfg.patch_size), conv_w.shape
    pre_ln_key = (
        "pre_layernorm" if "pre_layernorm.weight" in state else "pre_layrnorm"
    )
    params: Dict[str, Any] = {
        "patch_embed": {
            "proj": {
                "kernel": conv_w.transpose(2, 3, 1, 0).reshape(-1, D).astype(np.float32)
            }
        },
        "cls_token": take("embeddings.class_embedding")
        .reshape(1, 1, D)
        .astype(np.float32),
        "pos_embed": take("embeddings.position_embedding.weight")[None]
        .astype(np.float32),
        "norm_pre": ln(pre_ln_key),
        "norm": ln("post_layernorm"),
    }
    assert params["pos_embed"].shape == (1, cfg.seq_len, D), (
        params["pos_embed"].shape, cfg.seq_len,
    )
    for i in range(cfg.depth):
        b = f"encoder.layers.{i}"
        q = dense(f"{b}.self_attn.q_proj")
        k = dense(f"{b}.self_attn.k_proj")
        v = dense(f"{b}.self_attn.v_proj")
        params[f"blocks_{i}"] = {
            "norm1": ln(f"{b}.layer_norm1"),
            "attn": {
                "qkv": {
                    "kernel": np.concatenate(
                        [q["kernel"], k["kernel"], v["kernel"]], axis=1
                    ),
                    "bias": np.concatenate([q["bias"], k["bias"], v["bias"]]),
                },
                "proj": dense(f"{b}.self_attn.out_proj"),
            },
            "norm2": ln(f"{b}.layer_norm2"),
            "mlp": {
                "fc1": dense(f"{b}.mlp.fc1"),
                "fc2": dense(f"{b}.mlp.fc2"),
            },
        }
    unused = set(state) - used
    # non-parameter buffers older transformers versions persist in state
    # dicts (e.g. embeddings.position_ids) are benign — they carry no
    # learned values and must not trip the strictness check
    unused = {k for k in unused if not k.endswith(".position_ids")}
    if unused:
        msg = (
            f"unused checkpoint keys: {sorted(unused)[:8]}"
            f"{'...' if len(unused) > 8 else ''}"
        )
        if strict:
            raise ValueError(msg)
        logger.warning(msg)
    return params


def params_to_timm_vit(params: Mapping[str, Any], cfg: ViTConfig) -> Dict[str, np.ndarray]:
    """Inverse mapping (JAX pytree → timm-keyed numpy state dict).

    Lets users of the reference consume checkpoints trained here with their
    existing torch tooling, and powers round-trip tests.
    """
    out: Dict[str, np.ndarray] = {}

    def put_dense(prefix: str, leaf: Mapping[str, Any]):
        out[f"{prefix}.weight"] = np.asarray(leaf["kernel"]).T
        out[f"{prefix}.bias"] = np.asarray(leaf["bias"])

    def put_ln(prefix: str, leaf: Mapping[str, Any]):
        out[f"{prefix}.weight"] = np.asarray(leaf["ln"]["scale"])
        out[f"{prefix}.bias"] = np.asarray(leaf["ln"]["bias"])

    D = cfg.embed_dim
    kernel = np.asarray(params["patch_embed"]["proj"]["kernel"])
    out["patch_embed.proj.weight"] = (
        kernel.reshape(cfg.patch_size, cfg.patch_size, 3, D).transpose(3, 2, 0, 1)
    )
    out["patch_embed.proj.bias"] = np.asarray(params["patch_embed"]["proj"]["bias"])
    out["cls_token"] = np.asarray(params["cls_token"])
    out["pos_embed"] = np.asarray(params["pos_embed"])
    put_ln("norm", params["norm"])
    put_dense("head", params["head"])
    for i in range(cfg.depth):
        blk = params[f"blocks_{i}"]
        put_ln(f"blocks.{i}.norm1", blk["norm1"])
        put_dense(f"blocks.{i}.attn.qkv", blk["attn"]["qkv"])
        put_dense(f"blocks.{i}.attn.proj", blk["attn"]["proj"])
        put_ln(f"blocks.{i}.norm2", blk["norm2"])
        put_dense(f"blocks.{i}.mlp.fc1", blk["mlp"]["fc1"])
        put_dense(f"blocks.{i}.mlp.fc2", blk["mlp"]["fc2"])
    return out
