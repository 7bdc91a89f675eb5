"""The plain reference that decides ``correct``: a ViT with fake-quant sites,
its KD + QAT train step, post-training quantization and the true-int8
forward, in plain PyTorch.

It imports nothing of the measured package. It follows the published
descriptions: timm's ViT geometry (patch 16, cls token, learned positions,
pre-norm blocks), and as options CLIP's vision tower (pre-encoder LayerNorm,
quick-GELU, bias-free patch projection), torch's ``prepare_qat`` sites on a
ViT (every dense weight, the output of every dense layer and LayerNorm, the
input stub), torch's fused moving-average observers (EMA 0.01) and
``ChooseQuantizationParams``, the observers' convert-time qparams, KD as
``alpha * KL(T) * T^2 + (1 - alpha) * CE(label smoothing)``, clip-by-global-norm
then AdamW.

Precision: everything in float32 with TF32 off (integer GEMMs exact in
float64). ``Numerics.fp8`` computes every matmul as fp8 training does
(operands in e4m3, gradients in e5m2, a scale per tensor): the control, one
precision below the bf16 the configurations state.

Parameters are a flat dict keyed by the names the benchmark gives its
weights (``blocks.3.attn.qkv.weight`` ...); observer state is a dict
``site -> [min, max]`` of 0-d float32 tensors (``+inf`` / ``-inf`` before
the first observation).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
FLOAT32_EPS = 1.1920928955078125e-07
SMALL_SCALE = 6.0999998822808266e-05
EMA = 0.01
REPLAY = "__replay__"  # observer-state flag: a block recomputed in the backward
ACT_Q = (0, 255)  # qnnpack activations: uint8 affine
W_Q = (-128, 127)  # weights: int8 symmetric


@dataclasses.dataclass(frozen=True)
class Arch:
    """A ViT's geometry: ``act`` "gelu" (erf), "gelu_tanh" or "quick_gelu"."""

    embed_dim: int
    depth: int
    num_heads: int
    mlp_dim: int
    image_size: int
    patch_size: int = 16
    num_classes: int = 10
    act: str = "gelu"
    pre_norm: bool = False
    patch_bias: bool = True
    eps: float = 1e-6

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def seq_len(self) -> int:
        return self.grid * self.grid + 1

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads


@dataclasses.dataclass(frozen=True)
class Numerics:
    """``fp8``: every matmul in float8 as fp8 training computes it (the
    control): operands rounded to e4m3 in the forward, the incoming
    gradient to e5m2 in the backward, each tensor with its own scale."""

    fp8: bool = False


def _to_fp8(t: torch.Tensor, dtype) -> torch.Tensor:
    top = 448.0 if dtype == torch.float8_e4m3fn else 57344.0
    s = t.abs().amax().clamp(min=1e-30) / top
    return (t / s).to(dtype).to(torch.float32) * s


class _Fp8MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _to_fp8(a, torch.float8_e4m3fn), _to_fp8(b, torch.float8_e4m3fn)
        ctx.save_for_backward(qa, qb)
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        g8 = _to_fp8(g, torch.float8_e5m2)
        da = torch.matmul(g8, qb.transpose(-1, -2))
        db = torch.matmul(qa.transpose(-1, -2), g8)
        if db.dim() > qb.dim():  # a batched operand against a shared one
            db = db.reshape(-1, *qb.shape).sum(0)
        return da, db


def matmul(a, b, num: Numerics):
    return _Fp8MatMul.apply(a, b) if num.fp8 else torch.matmul(a, b)


def linear(x, w, b, num: Numerics):
    y = matmul(x, w.t(), num)
    return y if b is None else y + b


def layer_norm(x, w, b, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w + b


def activation(x, act: str):
    if act == "gelu":
        return F.gelu(x)
    if act == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    if act == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    raise ValueError(act)


def patches_of(x: torch.Tensor, p: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, (H/p)(W/p), p*p*C], rows in (ph, pw, c) order."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // p) * (w // p), p * p * c)


def attention(qkv, heads: int, num: Numerics):
    """Softmax attention over a packed [B, N, 3D] qkv, float32."""
    b, n, d3 = qkv.shape
    d = d3 // 3
    hd = d // heads
    q, k, v = qkv.reshape(b, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
    s = matmul(q, k.transpose(-1, -2), num) / math.sqrt(hd)
    p = torch.softmax(s, dim=-1)
    o = matmul(p, v, num)
    return o.transpose(1, 2).reshape(b, n, d)


# ---------------------------------------------------------------------------
# preprocessing: bicubic (Keys a = -0.5, half-pixel centres, taps
# renormalized) and ImageNet normalization, as jax.image.resize upsamples
# ---------------------------------------------------------------------------

def resize_matrix(src: int, dst: int) -> np.ndarray:
    scale = dst / src
    pos = (np.arange(dst, dtype=np.float64) + 0.5) / scale - 0.5
    d = np.abs(pos[:, None] - np.arange(src, dtype=np.float64)[None, :])
    w = np.where(d < 1, (1.5 * d - 2.5) * d * d + 1,
                 np.where(d < 2, ((-0.5 * d + 2.5) * d - 4) * d + 2, 0.0))
    tot = w.sum(1, keepdims=True)
    w = np.where(np.abs(tot) > 1000 * np.finfo(np.float32).eps, w / np.where(tot != 0, tot, 1), 0)
    w = np.where(((pos >= -0.5) & (pos <= src - 0.5))[:, None], w, 0.0)
    return w.astype(np.float32)


def preprocess(images_u8: torch.Tensor, size: int) -> torch.Tensor:
    x = images_u8.to(torch.float32) / 255.0
    _, h, w, _ = x.shape
    if (h, w) != (size, size):
        rh = torch.from_numpy(resize_matrix(h, size)).to(x.device)
        rw = torch.from_numpy(resize_matrix(w, size)).to(x.device)
        x = torch.einsum("Hh,bhwc->bHwc", rh, x)
        x = torch.einsum("Ww,bHwc->bHWc", rw, x)
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    return (x - mean) / std


# ---------------------------------------------------------------------------
# observers and fake-quant (train time) and convert-time qparams
# ---------------------------------------------------------------------------

def observe(state, key: str, x: torch.Tensor):
    if state.get(REPLAY):  # a recomputed block: its observers already saw this batch
        return state[key]
    lo, hi = x.detach().min().float(), x.detach().max().float()
    mn, mx = state[key]
    if torch.isinf(mn):
        state[key] = [lo, hi]
    else:
        state[key] = [mn + EMA * (lo - mn), mx + EMA * (hi - mx)]
    return state[key]


def choose_affine(mn, mx, qmin, qmax):
    """torch's ChooseQuantizationParams as its fused QAT kernel applies it."""
    mn, mx = torch.clamp(mn, max=0.0), torch.clamp(mx, min=0.0)
    scale = (mx - mn) / float(qmax - qmin)
    if float(scale) == 0.0:
        return torch.tensor(0.1, device=mn.device), torch.tensor(float(qmin), device=mn.device)
    rmin, rmax = mn / scale, mx / scale
    zp = torch.where(abs(qmin) - rmin.abs() < abs(qmax) - rmax.abs(), qmin - rmin, qmax - rmax)
    zp = torch.clamp(torch.round(zp), qmin, qmax)
    return torch.clamp(scale, min=SMALL_SCALE), zp


def choose_symmetric(mn, mx, qmin, qmax):
    if float(mn) < 0.0 < float(mx):
        half = (qmax - qmin) // 2
        scale = torch.maximum(-mn / float(half + 1), mx / float(half))
        return torch.clamp(scale, min=SMALL_SCALE), torch.zeros((), device=mn.device)
    return choose_affine(mn, mx, qmin, qmax)


class _FakeQuant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, zp, qmin, qmax):
        q = torch.round(x / scale + zp)
        ctx.save_for_backward((q >= qmin) & (q <= qmax))
        return (torch.clamp(q, qmin, qmax) - zp) * scale

    @staticmethod
    def backward(ctx, g):
        (mask,) = ctx.saved_tensors
        return g * mask, None, None, None, None


def fq_site(state, key, x, *, weight: bool):
    """Observe (EMA), choose train-time qparams, fake-quantize (STE)."""
    mn, mx = observe(state, key, x)
    qmin, qmax = W_Q if weight else ACT_Q
    scale, zp = (choose_symmetric if weight else choose_affine)(mn, mx, qmin, qmax)
    return _FakeQuant.apply(x, scale, zp, qmin, qmax)


def site_names(arch: Arch):
    """Every fake-quant site of the model, as ``(key, is_weight)``."""
    dense = ["patch_embed.proj"]
    for i in range(arch.depth):
        dense += [f"blocks.{i}.attn.qkv", f"blocks.{i}.attn.proj",
                  f"blocks.{i}.mlp.fc1", f"blocks.{i}.mlp.fc2"]
    if arch.num_classes:
        dense.append("head")
    lns = ["norm"] + [f"blocks.{i}.norm{j}" for i in range(arch.depth) for j in (1, 2)]
    if arch.pre_norm:
        lns.append("norm_pre")
    out = [("input_fq", False)]
    out += [(f"{d}.weight_fq", True) for d in dense] + [(f"{d}.act_fq", False) for d in dense]
    return out + [(f"{n}.act_fq", False) for n in lns]


def fresh_state(arch: Arch, device):
    inf = torch.tensor(float("inf"), device=device)
    state = {k: [inf, -inf] for k, _ in site_names(arch)}
    state[REPLAY] = False
    return state


def param_shapes(arch: Arch):
    """Every parameter of the model as ``(name, shape)``."""
    d, m, p = arch.embed_dim, arch.mlp_dim, arch.patch_size
    out = [("patch_embed.proj.weight", (d, 3 * p * p))]
    if arch.patch_bias:
        out.append(("patch_embed.proj.bias", (d,)))
    out += [("cls_token", (1, 1, d)), ("pos_embed", (1, arch.seq_len, d))]
    if arch.pre_norm:
        out += [("norm_pre.ln.weight", (d,)), ("norm_pre.ln.bias", (d,))]
    for i in range(arch.depth):
        b = f"blocks.{i}"
        out += [(f"{b}.norm1.ln.weight", (d,)), (f"{b}.norm1.ln.bias", (d,)),
                (f"{b}.attn.qkv.weight", (3 * d, d)), (f"{b}.attn.qkv.bias", (3 * d,)),
                (f"{b}.attn.proj.weight", (d, d)), (f"{b}.attn.proj.bias", (d,)),
                (f"{b}.norm2.ln.weight", (d,)), (f"{b}.norm2.ln.bias", (d,)),
                (f"{b}.mlp.fc1.weight", (m, d)), (f"{b}.mlp.fc1.bias", (m,)),
                (f"{b}.mlp.fc2.weight", (d, m)), (f"{b}.mlp.fc2.bias", (d,))]
    out += [("norm.ln.weight", (d,)), ("norm.ln.bias", (d,))]
    if arch.num_classes:
        out += [("head.weight", (arch.num_classes, d)), ("head.bias", (arch.num_classes,))]
    return out


# ---------------------------------------------------------------------------
# the float / fake-quant forward
# ---------------------------------------------------------------------------

def _once_then_replay(fn, state):
    """``fn`` for a checkpointed block: its first run observes, its
    recompute in the backward replays the observers' statistics."""
    calls = []

    def run(*args):
        replay = bool(calls)
        calls.append(1)
        if state is not None:
            state[REPLAY] = replay
        try:
            return fn(*args)
        finally:
            if state is not None:
                state[REPLAY] = False

    return run


def forward(P: Dict[str, torch.Tensor], x: torch.Tensor, arch: Arch, *,
            state=None, num: Numerics = Numerics(), recompute: bool = False) -> torch.Tensor:
    """Preprocessed NHWC images -> logits ([B, classes]) or, in feature mode
    (``num_classes`` 0), the final-LN tokens [B, N, D]. With ``state`` every
    fake-quant site observes and fake-quantizes. ``recompute``: each block
    keeps only its input for the backward and runs again there (the same
    values: its observers replay this step's statistics), so a large batch
    fits."""
    fq = state is not None

    def act(key, y):
        return fq_site(state, f"{key}.act_fq", y, weight=False) if fq else y

    def dense(name, y):
        w = P[f"{name}.weight"]
        if fq:
            w = fq_site(state, f"{name}.weight_fq", w, weight=True)
        return act(name, linear(y, w, P.get(f"{name}.bias"), num))

    def ln(name, y):
        return act(name, layer_norm(y, P[f"{name}.ln.weight"], P[f"{name}.ln.bias"], arch.eps))

    if fq:
        x = fq_site(state, "input_fq", x, weight=False)
    x = dense("patch_embed.proj", patches_of(x, arch.patch_size))
    b = x.shape[0]
    x = torch.cat([P["cls_token"].expand(b, 1, arch.embed_dim), x], 1) + P["pos_embed"]
    if arch.pre_norm:
        x = ln("norm_pre", x)
    def block(x, i):
        pre = f"blocks.{i}"
        qkv = dense(f"{pre}.attn.qkv", ln(f"{pre}.norm1", x))
        x = x + dense(f"{pre}.attn.proj", attention(qkv, arch.num_heads, num))
        h = activation(dense(f"{pre}.mlp.fc1", ln(f"{pre}.norm2", x)), arch.act)
        return x + dense(f"{pre}.mlp.fc2", h)

    for i in range(arch.depth):
        if recompute and torch.is_grad_enabled():
            x = torch.utils.checkpoint.checkpoint(_once_then_replay(block, state), x, i,
                                                  use_reentrant=False)
        else:
            x = block(x, i)
    x = ln("norm", x)
    if not arch.num_classes:
        return x
    return dense("head", x[:, 0])


# ---------------------------------------------------------------------------
# KD + QAT train step
# ---------------------------------------------------------------------------

def kd_loss(s_logits, t_logits, labels, alpha, temperature, smoothing):
    logp = F.log_softmax(s_logits, -1)
    ce = (-(1 - smoothing) * logp.gather(-1, labels[:, None])[:, 0] - smoothing * logp.mean(-1)).mean()
    s_t = F.log_softmax(s_logits / temperature, -1)
    t_t = F.log_softmax(t_logits / temperature, -1)
    kd = (t_t.exp() * (t_t - s_t)).sum(-1).mean() * temperature ** 2
    return alpha * kd + (1 - alpha) * ce


class AdamW:
    """Clip by global norm (no epsilon), then AdamW (decoupled decay)."""

    def __init__(self, params, lr, wd, clip, b1=0.9, b2=0.999, eps=1e-8):
        self.p, self.lr, self.wd, self.clip = params, lr, wd, clip
        self.b1, self.b2, self.eps, self.t = b1, b2, eps, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, grads) -> Dict[str, torch.Tensor]:
        """Applies one update; returns the clipped gradients."""
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
        f = 1.0 if float(norm) < self.clip else self.clip / norm
        self.t += 1
        bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        clipped = {}
        for k, p in self.p.items():
            g = grads[k] * f
            clipped[k] = g
            p.mul_(1 - self.lr * self.wd)
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(self.lr / bc1 * self.m[k] / (self.v[k].sqrt() / math.sqrt(bc2) + self.eps))
        return clipped


def qat_steps(P0, teacher_logits_fn, batches, arch: Arch, hp, num: Numerics = Numerics()):
    """The KD + QAT steps from fresh observers and fresh moments over
    ``batches`` (each ``(images_u8, labels)``): per step the loss, the first
    step's clipped gradients and the parameters after the last step."""
    P = {k: v.detach().clone().float().requires_grad_(True) for k, v in P0.items()}
    state = fresh_state(arch, next(iter(P.values())).device)
    opt = AdamW(P, hp["lr"], hp["weight_decay"], hp["grad_clip_norm"])
    losses, first_grads = [], None
    for images, labels in batches:
        x = preprocess(images, arch.image_size)
        t_logits = teacher_logits_fn(x)
        logits = forward(P, x, arch, state=state, num=num, recompute=True)
        loss = kd_loss(logits, t_logits, labels, hp["kd_alpha"], hp["kd_temperature"],
                       hp["label_smoothing"])
        grads = torch.autograd.grad(loss, list(P.values()))
        clipped = opt.step(dict(zip(P.keys(), grads)))
        losses.append(float(loss.detach()))
        if first_grads is None:
            first_grads = clipped
    return losses, first_grads, {k: v.detach() for k, v in P.items()}


# ---------------------------------------------------------------------------
# post-training quantization and the int8 forward
# ---------------------------------------------------------------------------

def observer_affine(mn, mx, qmin=ACT_Q[0], qmax=ACT_Q[1]):
    """Convert-time affine qparams (the observer's calculate_qparams)."""
    mn, mx = torch.clamp(mn, max=0.0), torch.clamp(mx, min=0.0)
    scale = torch.clamp((mx - mn) / float(qmax - qmin), min=FLOAT32_EPS)
    zp = torch.clamp(qmin - torch.round(mn / scale), qmin, qmax)
    return float(scale), float(zp)


def _act_range_after(act: str, a: float, b: float):
    """The output range of the MLP activation for inputs in [a, b]."""
    if act in ("gelu", "gelu_tanh"):
        g = lambda v: v * 0.5 * (1 + math.erf(v / math.sqrt(2)))  # noqa: E731
        lo = min(g(a), g(b), -0.17 if a < -0.7518 else g(a))
        return lo, max(g(b), 0.0)
    v = torch.linspace(a, b, 1025, dtype=torch.float64)
    y = v * torch.sigmoid(1.702 * v)
    return min(float(y.min()), 0.0), max(float(y.max()), 0.0)


@torch.no_grad()
def ptq_export(P, calib_images, arch: Arch):
    """Calibrate the observers with fake-quant forwards over the calibration
    batches (preprocessed images), then fold them: int8 weights, their scales
    and every activation's ``(scale, zero_point)``."""
    state = fresh_state(arch, calib_images[0].device)
    for x in calib_images:
        forward(P, x, arch, state=state)
    ex = {"act": {}, "w": {}}
    for key, is_w in site_names(arch):
        mn, mx = state[key]
        if is_w:
            continue
        ex["act"][key] = observer_affine(mn, mx)
    for key, is_w in site_names(arch):
        if not is_w:
            continue
        name = key[: -len(".weight_fq")]
        mn, mx = state[key]
        amax = max(-min(float(mn), 0.0), max(float(mx), 0.0))
        s = max(amax / 127.5, FLOAT32_EPS)
        w = P[f"{name}.weight"].float()
        ex["w"][name] = (torch.clamp(torch.round(w / s), -128, 127), s)
    for i in range(arch.depth):
        mn, mx = state[f"blocks.{i}.mlp.fc1.act_fq"]
        lo, hi = _act_range_after(arch.act, float(torch.nan_to_num(mn)), float(mx))
        ex["act"][f"blocks.{i}.gelu"] = observer_affine(torch.tensor(lo), torch.tensor(hi))
    return ex


def quantize(x, q, qmax=255.0, bits=8):
    """Activation onto its uint8 grid; ``bits`` < 8 coarsens the grid (the
    int4 control: the same range on 2**bits - 1 steps)."""
    s, zp = q
    if bits == 8:
        return torch.clamp(torch.round(x / s + zp), 0, qmax), s, zp
    steps = 2 ** bits - 1
    s4 = s * 255.0 / steps
    zp4 = round(zp * steps / 255.0)
    return torch.clamp(torch.round(x / s4 + zp4), 0, steps), s4, zp4


@torch.no_grad()
def int8_forward(P, ex, x, arch: Arch, serve_act: Optional[str] = None, bits: int = 8):
    """The true-int8 forward of the export ``ex`` over preprocessed images:
    every GEMM on integer operands (exact, in float64), the stream, LayerNorm,
    softmax and the activation in float32. ``bits`` 4 is the control."""
    act = serve_act or arch.act
    A = ex["act"]

    def wq(name):
        w, s = ex["w"][name]
        if bits == 8:
            return w, s
        s4 = s * 127.5 / (2 ** (bits - 1) - 0.5)
        return torch.clamp(torch.round(w * s / s4), -(2 ** (bits - 1)), 2 ** (bits - 1) - 1), s4

    def gemm(name, xq, sx, zx):
        w, sw = wq(name)
        acc = torch.matmul((xq - zx).double(), w.double().t())
        y = (acc * (sx * sw)).float()
        b = P.get(f"{name}.bias")
        return y if b is None else y + b.float()

    def qdense(name, y, in_key):
        return gemm(name, *quantize(y, A[in_key], bits=bits))

    def ln(name, y):
        return layer_norm(y, P[f"{name}.ln.weight"], P[f"{name}.ln.bias"], arch.eps)

    x = qdense("patch_embed.proj", patches_of(x, arch.patch_size), "input_fq")
    b = x.shape[0]
    x = torch.cat([P["cls_token"].expand(b, 1, arch.embed_dim), x], 1) + P["pos_embed"]
    if arch.pre_norm:
        x = ln("norm_pre", x)
    for i in range(arch.depth):
        pre = f"blocks.{i}"
        qkv = qdense(f"{pre}.attn.qkv", ln(f"{pre}.norm1", x), f"{pre}.norm1.act_fq")
        step = max(1, int(2e9 // (arch.num_heads * arch.seq_len ** 2 * 4 * 3)))
        o = torch.cat([attention(qkv[j:j + step], arch.num_heads, Numerics())
                       for j in range(0, b, step)])
        # the attention output rides on the qkv output's grid
        x = x + qdense(f"{pre}.attn.proj", o, f"{pre}.attn.qkv.act_fq")
        h = qdense(f"{pre}.mlp.fc1", ln(f"{pre}.norm2", x), f"{pre}.norm2.act_fq")
        x = x + qdense(f"{pre}.mlp.fc2", activation(h, act), f"{pre}.gelu")
    z = ln("norm", x)
    if not arch.num_classes:
        zq, s, zp = quantize(z, A["norm.act_fq"], bits=bits)
        return (zq - zp) * s
    return qdense("head", z[:, 0], "norm.act_fq")
