"""A run with its timed path broken underneath must come out not correct.

The harness's look for a card is skipped: each cell's window runs here on
the CPU at a micro size (the program's plain paths), once sound and once
with a planted fault for each fault the cell can have: a step that leaves
the state unchanged, a step on half of each batch with the mean over the
rest, an answer altered where it is produced. The limits are the cell's
own (``portbench/limits/``)."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench.tests.micro import run_micro  # noqa: E402

def unchanged_state(trainer):
    trainer.state.optimizer.step = lambda: None


def half_batch(trainer):
    inner = trainer.next_step_fn

    def next_fn():
        step = inner()
        return lambda state, batch, hp: step(
            state, {k: v[: len(v) // 2] for k, v in batch.items()}, hp)

    trainer.next_step_fn = next_fn


def altered_logits(pred):
    inner = pred._forward

    def forward(chunk):
        out = inner(chunk).clone()
        out[0] = out[1]
        return out

    pred._forward = forward


FAULTS = [("vit_s16_kd.train_qat", unchanged_state), ("vit_s16_kd.train_qat", half_batch),
          ("vit_s16_kd.serve_int8", altered_logits)]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=lambda f: getattr(f, "__name__", f))
def test_a_planted_fault_is_not_correct(cell, fault):
    sound = run_micro(cell)
    broken = run_micro(cell, plant=fault)
    assert broken["correct"] is False, broken["compared"]
    worst = max(c["value"] / c["limit"] for c in broken["compared"].values())
    assert worst > max(c["value"] / c["limit"] for c in sound["compared"].values())
