"""Port parity for resume files, on the CPU: ``resume_state.msgpack`` of
either package resumes in the other.

One JAX micro trainer (vit_micro_test, f32: ``amp`` and ``qat_amp`` off, so
both packages take the einsum attention; one device) takes one QAT step and
writes its resume file. The port's ``load_resume_state`` restores it
exactly (parameters, observers, AdamW's ``exp_avg`` / ``exp_avg_sq`` /
``step``, learning rate), writes it back byte for byte, sidecar included,
and one more step from the restored state is held to JAX's as
``test_train_step_f32_matches_jax`` holds steps. A port-written file loads
into JAX's ``load_resume_state``; the leaves inside the msgpack win over a
stale sidecar; a resumed port trainer continues as the one that saved;
detection resume round-trips on the micro detector.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qat_vit_tpu.models.registry import create_model as jax_create_model
from qat_vit_tpu.parallel import make_mesh
from qat_vit_tpu.train.config import DEFAULT_HPARAMS as JAX_DEFAULTS
from qat_vit_tpu.train.trainer import KDQATTrainer as JaxTrainer
from qat_vit_tpu_torch.data.cifar10 import synthetic_cifar10
from qat_vit_tpu_torch.models import jax_params
from qat_vit_tpu_torch.models.registry import create_model
from qat_vit_tpu_torch.train.config import DEFAULT_HPARAMS
from qat_vit_tpu_torch.train.trainer import KDQATTrainer


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's micro models, restored after
    it: their ops are tiny, and under pytest-xdist every worker's default
    threads would contend for the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


B = 8


def _hp(**over):
    hp = dict(DEFAULT_HPARAMS)
    hp.update({"lr": 1e-3, "weight_decay": 1e-3, "grad_clip_norm": 0.05, "batch_size": B,
               "eval_batch_size": B, "image_size": 32, "epochs": 2, "amp": False,
               "qat_amp": False}, **over)
    return hp


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"image": rng.integers(0, 256, (B, 32, 32, 3), dtype=np.uint8),
            "label": rng.integers(0, 10, B).astype(np.int32),
            "teacher_logits": rng.normal(0, 2, (B, 10)).astype(np.float32)}


DATA = synthetic_cifar10(n_train=32, n_test=8)


def _jax_trainer():
    hp = {k: v for k, v in _hp().items() if k in JAX_DEFAULTS}
    return JaxTrainer(hp, data=DATA, mesh=make_mesh(data=1, devices=jax.devices()[:1]),
                      student=jax_create_model("vit_micro_test"),
                      teacher=jax_create_model("vit_micro_test"))


def _jax_step(jt, seed):
    b = {k: jnp.asarray(v) for k, v in _batch(seed).items()}
    jt.state, metrics = jt.train_step_qat(jt.state, jt.teacher_params, b, jt.loss_hp)
    return metrics


def _port_trainer(**over):
    g = torch.Generator().manual_seed(5)
    return KDQATTrainer(_hp(**over), device="cpu", data=DATA,
                        student=create_model("vit_micro_test", qat_wrapper=True, generator=g),
                        teacher=create_model("vit_micro_test", generator=g))


def _port_step(t, seed):
    b = _batch(seed)
    tb = {"image": torch.from_numpy(b["image"]), "label": torch.from_numpy(b["label"]).long(),
          "teacher_logits": torch.from_numpy(b["teacher_logits"])}
    return t.next_step_fn()(t.state, tb, t.loss_hp)


@pytest.fixture(scope="module")
def jax_file(tmp_path_factory):
    """A JAX trainer's resume file after one QAT step (epoch 1), and the
    trainer."""
    d = tmp_path_factory.mktemp("resume")
    jt = _jax_trainer()
    jt.enable_qat()
    _jax_step(jt, 0)
    return jt, jt.save_resume_state(str(d / "resume_state.msgpack"), epoch=1)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def _assert_same_state(t, jstate):
    """The port trainer's parameters, observers and AdamW state equal the JAX
    state's, exactly."""
    want_p = jax_params.params_to_state_dict(jax.device_get(jstate.params))
    for name, p in t.state.module.named_parameters():
        assert torch.equal(p.detach(), want_p[name]), name
    want_q = _flat(jax.device_get(jstate.quant_stats))
    got_q = _flat(jax_params.buffers_to_quant_stats(t.state.module.state_dict()))
    assert want_q.keys() == got_q.keys() and len(got_q) == 52
    for k in want_q:
        np.testing.assert_array_equal(got_q[k], want_q[k], err_msg=k)
    inject = jstate.opt_state[1]
    adam = inject.inner_state[0]
    mu = jax_params.params_to_state_dict(jax.device_get(adam.mu))
    nu = jax_params.params_to_state_dict(jax.device_get(adam.nu))
    for name, p in t.state.module.named_parameters():
        slot = t.state.optimizer.adamw.state[p]
        assert int(slot["step"]) == int(adam.count) == int(inject.count), name
        assert torch.equal(slot["exp_avg"], mu[name]) and torch.equal(slot["exp_avg_sq"],
                                                                       nu[name]), name
    group = t.state.optimizer.hyperparams
    assert np.float32(group["learning_rate"]) == inject.hyperparams["learning_rate"]
    assert np.float32(group["weight_decay"]) == inject.hyperparams["weight_decay"]
    assert t.state.step == int(jstate.step)


def test_port_reads_jax_resume_file_and_writes_it_back(jax_file, tmp_path):
    """The port restores the JAX file: epoch and QAT flag, parameters,
    observers and AdamW state exactly; saved again, the msgpack and its JSON
    sidecar are byte-identical to JAX's."""
    jt, path = jax_file
    t = _port_trainer()
    assert t.load_resume_state(path) == 2 and t.qat_enabled
    _assert_same_state(t, jt.state)
    again = t.save_resume_state(str(tmp_path / "again.msgpack"), epoch=1)
    assert open(again, "rb").read() == open(path, "rb").read()
    assert open(again + ".json", "rb").read() == open(path + ".json", "rb").read()


def test_step_after_resume_matches_jax(jax_file):
    """One more f32 QAT step from the restored states, each package's own:
    loss to rtol 1e-5, params to atol 1e-5 (the bounds of
    ``test_train_step_f32_matches_jax``), observers to rtol 1e-4."""
    _, path = jax_file
    jt = _jax_trainer()
    assert jt.load_resume_state(path) == 2
    t = _port_trainer()
    t.load_resume_state(path)
    jm = _jax_step(jt, 1)
    tm = _port_step(t, 1)
    for k in ("train_loss", "train_loss_ce", "train_loss_kd", "train_acc"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    want = jax_params.params_to_state_dict(jax.device_get(jt.state.params))
    for name, p in t.state.module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    want_q = _flat(jax.device_get(jt.state.quant_stats))
    got_q = _flat(jax_params.buffers_to_quant_stats(t.state.module.state_dict()))
    for k in want_q:
        np.testing.assert_allclose(got_q[k], want_q[k], rtol=1e-4, atol=1e-6, err_msg=k)
    assert t.state.step == int(jt.state.step) == 2


def test_jax_reads_port_resume_file(tmp_path):
    """A port file, after one QAT step of the port's own, loads into JAX's
    ``load_resume_state`` (its template restore checks the whole tree) with
    every leaf equal to the port's state; a float-phase file (empty
    ``quant_stats``, fresh moments) loads as well."""
    t = _port_trainer()
    float_path = t.save_resume_state(str(tmp_path / "float.msgpack"), epoch=0)
    t.enable_qat()
    _port_step(t, 0)
    path = t.save_resume_state(str(tmp_path / "resume_state.msgpack"), epoch=3)
    jt = _jax_trainer()
    assert jt.load_resume_state(path) == 4 and jt.qat_enabled
    _assert_same_state(t, jt.state)
    jf = _jax_trainer()
    assert jf.load_resume_state(float_path) == 1 and not jf.qat_enabled
    assert int(jf.state.opt_state[1].count) == 0
    want = jax_params.params_to_state_dict(jax.device_get(jf.state.params))
    for name, p in t.student_float.named_parameters():
        assert torch.equal(p.detach(), want[name]), name


def test_embedded_leaves_win_over_stale_sidecar(tmp_path):
    """Resume info comes from the leaves inside the msgpack, not from a JSON
    sidecar that a crash left stale; a file without them falls back to the
    sidecar."""
    t = _port_trainer()
    t.enable_qat()
    _port_step(t, 0)
    path = t.save_resume_state(str(tmp_path / "resume.msgpack"), epoch=0)
    with open(path + ".json", "w") as f:
        json.dump({"epoch": 7, "qat_enabled": False}, f)
    t2 = _port_trainer()
    assert t2.load_resume_state(path) == 1 and t2.qat_enabled


def test_resumed_port_trainer_continues_identically(tmp_path):
    """A trainer that loads another's resume file after one QAT step has its
    parameters, observers and AdamW state; one more step of each on the
    same batch gives identical losses and parameters (the fresh-moments
    case, a file saved before any QAT step, restores an empty AdamW
    state)."""
    t = _port_trainer(observer_interval=2)
    t.enable_qat()
    _port_step(t, 0)
    path = t.save_resume_state(str(tmp_path / "resume.msgpack"), epoch=0)
    t2 = _port_trainer(observer_interval=2)
    assert t2.load_resume_state(path) == 1
    for (n, a), (_, b) in zip(t.state.module.state_dict().items(),
                              t2.state.module.state_dict().items()):
        assert torch.equal(a, b), n
    for p, q in zip(t.state.module.parameters(), t2.state.module.parameters()):
        s, s2 = t.state.optimizer.adamw.state[p], t2.state.optimizer.adamw.state[q]
        assert all(torch.equal(s[k], s2[k]) for k in ("step", "exp_avg", "exp_avg_sq"))
    t._qat_py_step = t2._qat_py_step  # both observe next: the interval restarts on resume
    m, m2 = _port_step(t, 1), _port_step(t2, 1)
    assert all(torch.equal(m[k], m2[k]) for k in m)
    for (n, a), (_, b) in zip(t.state.module.state_dict().items(),
                              t2.state.module.state_dict().items()):
        assert torch.equal(a, b), n
    fresh = _port_trainer()
    fresh.enable_qat()
    p0 = fresh.save_resume_state(str(tmp_path / "fresh.msgpack"), epoch=0)
    t3 = _port_trainer()
    t3.load_resume_state(p0)
    assert t3.qat_enabled and not t3.state.optimizer.adamw.state


def test_detection_resume_roundtrip(tmp_path):
    """The micro detector (3 heads of 16, the long-sequence branch): a port
    ``DetectKDTrainer`` after one QAT step saves; a second one loads it with
    identical parameters, observers and AdamW state; JAX's
    ``DetectKDTrainer`` loads the same file with the same parameters."""
    from qat_vit_tpu.train.detect_trainer import DetectKDTrainer as JaxDetectTrainer
    from qat_vit_tpu_torch.train.detect_trainer import DetectKDTrainer

    geo = dict(patch_size=8, embed_dim=48, depth=2, num_heads=3, mlp_ratio=2.0)
    hp = _hp(task="detection", num_queries=2, text_dim=64, batch_size=4, eval_batch_size=4,
             **geo)
    data = synthetic_cifar10(n_train=8, n_test=4)
    t = DetectKDTrainer(hp, device="cpu", data=data)
    t.enable_qat()
    t.train_epoch(0, limit_batches=1)
    path = t.save_resume_state(str(tmp_path / "resume_state.msgpack"), epoch=0)
    t2 = DetectKDTrainer(hp, device="cpu", data=data)
    assert t2.load_resume_state(path) == 1 and t2.qat_enabled
    sd, sd2 = t.state.module.state_dict(), t2.state.module.state_dict()
    assert sd.keys() == sd2.keys() and len([k for k in sd if k.endswith("_val")]) == 50
    for k in sd:
        assert torch.equal(sd[k], sd2[k]), k
    for p, q in zip(t.state.module.parameters(), t2.state.module.parameters()):
        s, s2 = t.state.optimizer.adamw.state[p], t2.state.optimizer.adamw.state[q]
        assert all(torch.equal(s[k], s2[k]) for k in ("step", "exp_avg", "exp_avg_sq"))
    jhp = {k: v for k, v in hp.items() if k in JAX_DEFAULTS or k in geo or k == "query_seed"}
    jt = JaxDetectTrainer(jhp, data=data, mesh=make_mesh(data=1, devices=jax.devices()[:1]))
    assert jt.load_resume_state(path) == 1 and jt.qat_enabled
    want = jax_params.params_to_state_dict(jax.device_get(jt.state.params))
    for name, p in t.state.module.named_parameters():
        assert torch.equal(p.detach(), want[name]), name
    assert int(jt.state.opt_state[1].count) == 1
