"""qat_vit_tpu_torch — the PyTorch + CUDA (Hopper) port of ``qat_vit_tpu``.

The JAX package ``qat_vit_tpu`` is the reference; this package mirrors its
subpackages and module names so each counterpart is found at the same path:

- ``quant``: fake-quant ops, EMA min/max observers, qconfig, convert helpers;
- ``models``: the timm-geometry ViT as ``nn.Module``s, the model registry,
  and ``jax_params`` (numpy trees from the JAX package → this package);
- ``ops``: the int8 serving ops — hand-written CUDA kernels for ``sm_90a``
  (``csrc/``) with a plain PyTorch version of each beside it;
- ``serve``: PTQ calibration, the int8 export, the int8 forward and the
  batched predictor;
- ``data``: on-device preprocessing.

Importing the package touches neither CUDA nor a compiler: the kernels are
built from ``csrc/`` at their first launch (``_build.py``).
"""

__version__ = "0.1.0"
