"""Convert a torch ViT checkpoint (timm/HF layout) to the msgpack format
(port of ``scripts/convert_teacher.py``; for the same ``.pth`` it writes the
bytes the JAX script writes).

Replaces the reference's runtime HF download of
``edadaltocg/vit_base_patch16_224_in21k_ft_cifar10`` (reference
src/models/model_registry.py:186-189) with an offline conversion step:

    python -m qat_vit_tpu_torch.scripts.convert_teacher pytorch_model.bin teacher.msgpack \
        --model vit_base_patch16_224_teacher --num-classes 10

The output loads via ``--teacher-ckpt teacher.msgpack`` in either package's
trainer; the raw ``.pth``/``.bin`` also loads directly (converted on the
fly), this script just makes the conversion explicit and verifiable.
"""

from __future__ import annotations

import argparse

from qat_vit_tpu_torch.models.registry import create_architecture
from qat_vit_tpu_torch.models.torch_convert import load_torch_state_dict, timm_vit_to_params
from qat_vit_tpu_torch.utils.checkpoint import save_checkpoint


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("src", help="torch checkpoint (.pth/.bin)")
    p.add_argument("dst", help="output .msgpack")
    p.add_argument("--model", default="vit_base_patch16_224_teacher")
    p.add_argument("--num-classes", type=int, default=10)
    p.add_argument("--no-strict", action="store_true",
                   help="tolerate unused checkpoint keys")
    args = p.parse_args(argv)

    # the architecture's config alone (no weights drawn)
    cfg = create_architecture(args.model, num_classes=args.num_classes).cfg
    state = load_torch_state_dict(args.src)
    params = timm_vit_to_params(state, cfg, strict=not args.no_strict)
    save_checkpoint(args.dst, {"params": params},
                    {"source": args.src, "model": args.model,
                     "num_classes": args.num_classes})
    n = sum(v.size for v in state.values())
    print(f"converted {args.src} ({n:,} weights) -> {args.dst}")


if __name__ == "__main__":  # pragma: no cover
    main()
