#!/usr/bin/env bash
# Final KD+QAT training (reference scripts/train_final.sh:13-16 parity) with
# the PyTorch + CUDA port. One process on one card; for several ranks run
#   python -m torch.distributed.run --standalone --nproc_per_node N \
#       -m qat_vit_tpu_torch.train.trainer ...
# Extra args pass straight through (e.g. --config qat_search/best_params.yaml).
set -euo pipefail
exec python -m qat_vit_tpu_torch.train.trainer "$@"
