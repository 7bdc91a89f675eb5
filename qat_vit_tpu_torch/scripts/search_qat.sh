#!/usr/bin/env bash
# Hyperparameter search (reference scripts/search_qat.sh:9-16 parity) with
# the PyTorch + CUDA port:
#   ./qat_vit_tpu_torch/scripts/search_qat.sh [TRIALS] [EPOCHS] [OUTDIR]
set -euo pipefail
TRIALS="${1:-30}"
EPOCHS="${2:-10}"
OUTDIR="${3:-./qat_search}"
exec python -m qat_vit_tpu_torch.search.driver \
  --trials "${TRIALS}" --epochs "${EPOCHS}" --output-dir "${OUTDIR}"
