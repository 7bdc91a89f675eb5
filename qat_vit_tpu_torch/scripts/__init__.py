"""The functions users run end to end (ports of the JAX package's
``scripts/``): ``pretrain_teacher``, ``convert_teacher``, the accuracy and
detection loops, ``validate_real`` and the three shell wrappers
(``train_final.sh``, ``search_qat.sh``, ``evaluate.sh``).

Each module is a CLI, ``python -m qat_vit_tpu_torch.scripts.<name>``, with
the JAX script's flags, defaults, phases, artifact names and report format;
it runs on the card unless the caller passes ``device="cpu"`` to ``main``.
"""
