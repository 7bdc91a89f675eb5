"""Weights and inputs made from the run's seed, on the device, in a few
large calls: the same seed gives the same tensors, and both the program and
the reference are handed them."""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch

from portbench.lib.common import seeded


# the towers' dense weights at 1.5 / sqrt(fan_in): at timm's 0.02 the logits
# of two different images of ViT-S/16 differ by about as much as int8
# rounding moves one of them (7% against 4-6% of their norm), so a served
# answer could not be told from another image's; at this gain they differ by
# 25% against the same ~4%
TOWER_GAIN = 1.5


def generator(seed: int, salt: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seeded(seed, salt))


def make_params(shapes: Iterable[Tuple[str, Tuple[int, ...]]], seed: int, salt: int,
                device) -> Dict[str, torch.Tensor]:
    """float32 weights for ``(name, shape)`` pairs from one normal draw:
    dense weights truncated normals cut at 2 std, std ``TOWER_GAIN /
    sqrt(fan_in)``; LayerNorm scales 1; biases, LayerNorm shifts, the cls token and
    positions normal(0, 0.02)."""
    shapes = list(shapes)
    total = sum(int(torch.Size(s).numel()) for _, s in shapes)
    flat = torch.randn(total, generator=generator(seed, salt, device), device=device)
    out, off = {}, 0
    for name, shape in shapes:
        n = int(torch.Size(shape).numel())
        z = flat[off:off + n].view(shape)
        off += n
        if name.endswith("ln.weight"):
            out[name] = torch.ones(shape, device=device)
        elif len(shape) == 2:
            std = TOWER_GAIN * shape[1] ** -0.5
            out[name] = z.clamp(-2.0, 2.0) * std
        else:
            out[name] = z * 0.02
    return out


def cifar_like(n: int, seed: int, salt: int, device, classes: int = 10):
    """``n`` 32x32 RGB uint8 images and labels: a per-class colour pattern
    plus noise, drawn on the device."""
    g = generator(seed, salt, device)
    labels = torch.randint(0, classes, (n,), generator=g, device=device)
    yy, xx = torch.meshgrid(torch.linspace(0, 1, 32, device=device),
                            torch.linspace(0, 1, 32, device=device), indexing="ij")
    c = torch.arange(classes, device=device, dtype=torch.float32)[:, None, None]
    f = 1 + c % 5
    tmpl = torch.stack([torch.sin(6.2832 * f * xx + 0.7 * c), torch.cos(6.2832 * f * yy + 0.7 * c),
                        torch.sin(6.2832 * f * (xx + yy) + 0.7 * c)], -1)  # [C, 32, 32, 3]
    out = torch.empty((n, 32, 32, 3), dtype=torch.uint8, device=device)
    chunk = 8192
    for s in range(0, n, chunk):
        lab = labels[s:s + chunk]
        noise = torch.randn((len(lab), 32, 32, 3), generator=g, device=device) * 0.35
        img = (tmpl[lab] * 0.5 + noise) * 64 + 128
        out[s:s + chunk] = img.clamp(0, 255).round().to(torch.uint8)
    return out, labels
