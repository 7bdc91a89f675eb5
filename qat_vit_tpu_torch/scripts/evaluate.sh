#!/usr/bin/env bash
# Checkpoint comparison (reference scripts/evaluate.sh:7-13 parity) with the
# PyTorch + CUDA port.
#
# Usage (positional, like the reference):
#   ./qat_vit_tpu_torch/scripts/evaluate.sh [QAT_CKPT] [QUANT_CKPT] [extra comparator flags...]
set -euo pipefail

# Positional slots are checkpoints only when they don't look like flags —
# `evaluate.sh --qat-backend fbgemm` must not swallow the flag pair.
QAT_CKPT="./qat_output/best_qat.msgpack"
QUANT_CKPT="./qat_output/best_converted.msgpack"
if [[ $# -ge 1 && "${1}" != -* ]]; then
  QAT_CKPT="$1"; shift
  if [[ $# -ge 1 && "${1}" != -* ]]; then
    QUANT_CKPT="$1"; shift
  fi
fi

exec python -m qat_vit_tpu_torch.evaluation.comparator \
  --qat-ckpt "${QAT_CKPT}" \
  --quant-ckpt "${QUANT_CKPT}" \
  "$@"
