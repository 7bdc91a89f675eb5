"""Checkpoints and weights from files in the port, against the JAX package, on the CPU.

Every file here is written in ``tmp_path`` from seeded micro modules:

- the port's msgpack codec (``utils/msgpack_codec.py``) gives the bytes of
  ``flax.serialization.to_bytes`` for every leaf kind the JAX package writes (f32,
  f64, int8, int32, uint8, bool, bfloat16, 0-d and empty arrays, numpy and Python
  scalars, nested dicts, lists keyed ``"0"``...), flax's chunked arrays included,
  and reads flax's bytes back to trees it writes again byte for byte;
- params, quant_stats and int8 exports (GELU and quick-GELU) written by either
  package's ``save_checkpoint`` load in the other and are written back
  byte-identical; the same QAT state converted by each package gives identical
  export files;
- ``models/torch_convert.py`` and ``owlv2_detection_to_params`` against JAX's on a
  ``.pth`` with ``module.``, a nested ``state_dict`` and QAT stub keys, and on an HF
  ``Owlv2ForObjectDetection`` state dict from a tiny random-init model;
- the trainers' ``student_ckpt`` / ``teacher_ckpt`` and the detection trainer's
  ``student=`` / ``teacher=`` give the JAX package's params; ``resume`` still raises;
- ``Int8Predictor.from_checkpoint(device="cpu")`` against JAX's.
"""

import functools
import os

import numpy as np
import pytest

import flax.linen as nn
import jax
import jax.numpy as jnp
import ml_dtypes
import torch
from flax import serialization

from qat_vit_tpu.models import torch_convert as jtc
from qat_vit_tpu.models.owlv2_detect import owlv2_detection_to_params as jax_owlv2_detection
from qat_vit_tpu.models.registry import create_model as jax_create_model
from qat_vit_tpu.serve.int8_vit import convert_vit as jax_convert_vit
from qat_vit_tpu.serve.predictor import Int8Predictor as JaxInt8Predictor
from qat_vit_tpu.train.trainer import load_model_params as jax_load_model_params
from qat_vit_tpu.utils import checkpoint as jck
from qat_vit_tpu_torch.models import torch_convert as ttc
from qat_vit_tpu_torch.models.jax_params import (
    buffers_to_quant_stats,
    export_from_numpy,
    load_jax_variables,
    state_dict_to_params,
)
from qat_vit_tpu_torch.models.owlv2_detect import owlv2_detection_to_params
from qat_vit_tpu_torch.models.registry import create_model
from qat_vit_tpu_torch.serve.int8_vit import convert_vit
from qat_vit_tpu_torch.serve.predictor import Int8Predictor
from qat_vit_tpu_torch.utils import checkpoint as tck
from qat_vit_tpu_torch.utils import msgpack_codec as codec


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _same_tree(a, b):
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        x, y = (np.asarray(v.float() if isinstance(v, torch.Tensor) else v) for v in (fa[k], fb[k]))
        assert x.shape == y.shape and np.array_equal(x, y), k


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------

def _leaf_tree(bf16):
    r = np.random.default_rng(0)
    bf = np.arange(-3, 3, dtype=np.float32).reshape(2, 3) / 7
    return {
        "f32": r.normal(size=(3, 4)).astype(np.float32),
        "f64": r.normal(size=(5,)),
        "int8": r.integers(-128, 128, (40,), dtype=np.int8),
        "int32": r.integers(-2 ** 31, 2 ** 31, (3, 2), dtype=np.int32),
        "uint8": np.arange(300, dtype=np.uint8).reshape(20, 15),
        "bool": np.array([True, False, True]),
        "bf16": (torch.from_numpy(bf).to(torch.bfloat16) if bf16
                 else bf.astype(ml_dtypes.bfloat16)),
        "zero_d": np.asarray(np.float32(2.5)),
        "empty": np.zeros((0, 3), np.int32),
        "np_scalars": {"f32": np.float32(1.25), "i64": np.int64(-7), "b": np.bool_(True)},
        "nested": {"b": {"c": np.ones((2, 2), np.float32)}, "a": np.int32(3)},
        "list": [1, -1, 127, 128, -33, 255, 256, 65535, 65536, -2 ** 31, 2 ** 40, -2 ** 40,
                 2 ** 63],
        "python": {"float": 0.1, "str": "x" * 31, "str8": "y" * 200, "str16": "z" * 70_000,
                   "bytes": b"\x00" * 300, "none": None, "true": True, "complex": 1 - 2j},
        "tuple": (np.float32(0), "t"),
        "map16": {str(i): i for i in range(20)},
    }


def test_codec_bytes_are_flax_bytes():
    """Every leaf kind, the headers at their size limits (fixstr / str8 / str16,
    bin8 / bin16, fixmap / map16, fixarray, every int width), insertion order."""
    want = serialization.to_bytes(_leaf_tree(bf16=False))
    assert codec.packb(_leaf_tree(bf16=True)) == want
    back = codec.unpackb(want)
    assert isinstance(back["bf16"], torch.Tensor) and back["bf16"].dtype == torch.bfloat16
    assert isinstance(back["np_scalars"]["f32"], np.float32)
    assert back["list"]["12"] == 2 ** 63 and back["python"]["complex"] == 1 - 2j
    assert codec.packb(back) == want
    flax_back = serialization.msgpack_restore(want)
    _same_tree({k: v for k, v in flax_back.items() if k != "python"},
               {k: v for k, v in back.items() if k != "python"})
    assert flax_back["python"] == back["python"]


def test_codec_chunked_arrays(monkeypatch):
    """Arrays past the chunk size go as flax's ``__msgpack_chunked_array__``
    dicts (the size monkeypatched small in both), bf16 ones too, and come back whole."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(codec, "MAX_CHUNK_SIZE", 64)
    r = np.random.default_rng(1)
    bf = r.normal(size=(7, 9)).astype(np.float32)
    tree = {"big": r.normal(size=(5, 11)).astype(np.float32), "small": np.arange(3),
            "nested": {"big_i8": r.integers(-128, 128, (3, 50), dtype=np.int8)}}
    want = serialization.to_bytes({**tree, "bf": bf.astype(ml_dtypes.bfloat16)})
    assert codec.packb({**tree, "bf": torch.from_numpy(bf).to(torch.bfloat16)}) == want
    back = codec.unpackb(want)
    np.testing.assert_array_equal(back["big"], tree["big"])
    np.testing.assert_array_equal(back["nested"]["big_i8"], tree["nested"]["big_i8"])
    assert torch.equal(back["bf"], torch.from_numpy(bf).to(torch.bfloat16))
    assert codec.packb(back) == want


def test_codec_refuses_what_flax_refuses():
    with pytest.raises(TypeError):
        codec.packb({"obj": object()})
    with pytest.raises(ValueError, match="Object"):
        codec.packb({"obj": np.array([object()])})
    with pytest.raises(ValueError, match="unique string"):
        codec.packb({1: 0, "1": 1})


# ---------------------------------------------------------------------------
# checkpoints across the two packages
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_state(act):
    """A JAX micro QAT model's params and observed quant_stats, and its export."""
    jm = jax_create_model("vit_micro_test", qat_wrapper=True, act=act)
    v = nn.meta.unbox(jm.module.init(jax.random.key(0), jm.example_input(1), observe=False))
    x = np.random.default_rng(0).normal(0, 1, (8, 32, 32, 3)).astype(np.float32)
    _, mut = jm.module.apply({"params": v["params"], "quant_stats": v["quant_stats"]},
                             jnp.asarray(x), observe=True, mutable=["quant_stats"])
    params, stats = jax.device_get(v["params"]), jax.device_get(mut["quant_stats"])
    return jm.cfg, params, stats, jax.device_get(jax_convert_vit(params, stats, jm.cfg))


@pytest.fixture(scope="module", params=["gelu", "quick_gelu"])
def jax_state(request):
    return (request.param,) + _jax_state(request.param)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_checkpoints_cross_both_ways(jax_state, tmp_path):
    """Params, quant_stats (with the JSON sidecar) and the int8 export written by
    JAX load in the port and go back byte-identical; the port's files load in
    JAX and go back byte-identical; the same QAT state converted by each package
    gives the same export file."""
    act, jcfg, params, stats, jexp = jax_state
    trees = {"params": {"params": params, "quant_stats": stats}, "export": jexp}
    for name, tree in trees.items():
        jpath, tpath = str(tmp_path / f"{name}_j.msgpack"), str(tmp_path / f"{name}_t.msgpack")
        jck.save_checkpoint(jpath, tree, {"epoch": 3, "act": act})
        tck.save_checkpoint(tpath, tck.load_checkpoint(jpath), tck.load_metadata(jpath))
        assert _read(tpath) == _read(jpath) and _read(tpath + ".json") == _read(jpath + ".json")
        back = str(tmp_path / f"{name}_jt.msgpack")
        jck.save_checkpoint(back, jck.load_checkpoint(tpath))
        assert _read(back) == _read(jpath)
    tm = create_model("vit_micro_test", qat_wrapper=True, act=act)
    load_jax_variables(tm.module, params, stats)
    sd = tm.module.state_dict()
    tck.save_checkpoint(str(tmp_path / "export_port.msgpack"), convert_vit(sd, sd, tm.cfg))
    assert _read(tmp_path / "export_port.msgpack") == _read(tmp_path / "export_j.msgpack")
    tck.save_checkpoint(str(tmp_path / "p_port.msgpack"),
                        {"params": state_dict_to_params(sd),
                         "quant_stats": buffers_to_quant_stats(sd)})
    assert _read(tmp_path / "p_port.msgpack") == _read(tmp_path / "params_j.msgpack")


def test_load_with_template_and_tolerant_merge(tmp_path):
    """``load_checkpoint`` with a template as flax's ``from_bytes``: the
    template's structure and key order, lists back as lists, missing keys
    raise; ``tolerant_merge`` as JAX's: missing and shape-changed leaves keep
    the template, unexpected ones are reported, dtypes follow the template."""
    tree = {"b": [np.float32(1), np.arange(3)], "a": {"x": np.ones(2, np.float32)}, "s": 4}
    path = str(tmp_path / "t.msgpack")
    jck.save_checkpoint(path, tree)
    template = {"a": {"x": 0}, "b": [0, 0], "s": 0}
    got, want = tck.load_checkpoint(path, template), jck.load_checkpoint(path, template)
    assert list(got) == list(want) == ["a", "b", "s"] and isinstance(got["b"], list)
    _same_tree({"a": got["a"], "b": dict(enumerate(got["b"])), "s": got["s"]},
               {"a": want["a"], "b": dict(enumerate(want["b"])), "s": want["s"]})
    with pytest.raises(ValueError, match="not in the checkpoint"):
        tck.load_checkpoint(path, {**template, "c": 0})
    tmpl = {"a": {"x": np.zeros(2, np.float64), "y": np.zeros(1)}, "s": np.zeros(3)}
    restored = tck.load_checkpoint(path)
    for merge in (tck.tolerant_merge, jck.tolerant_merge):
        merged, missing, unexpected = merge(tmpl, restored)
        assert merged["a"]["x"].dtype == np.float64 and merged["a"]["x"].tolist() == [1, 1]
        assert missing == [("a", "y"), ("s",)] and unexpected == [("b",)]
    t_tmpl = {"a": {"x": torch.zeros(2, dtype=torch.bfloat16)}}
    merged, _, _ = tck.tolerant_merge(t_tmpl, restored)
    assert merged["a"]["x"].dtype == torch.bfloat16 and merged["a"]["x"].tolist() == [1, 1]


def test_best_checkpointer(tmp_path):
    best = tck.BestCheckpointer(str(tmp_path))
    assert best.maybe_save(0.5, {"w": np.ones(2)}, {"epoch": 0})[0]
    assert not best.maybe_save(0.4, {"w": np.zeros(2)})[0]
    assert best.maybe_save(0.7, {"w": np.full(2, 3.0)}, {"epoch": 2}) == (
        True, str(tmp_path / "best_qat.msgpack"))
    assert tck.load_metadata(best.best_path) == {"epoch": 2, "metric": 0.7}
    np.testing.assert_array_equal(jck.load_checkpoint(best.best_path)["w"], [3.0, 3.0])
    assert tck.load_metadata(str(tmp_path / "none.msgpack")) == {}


# ---------------------------------------------------------------------------
# torch checkpoints: timm and HF layouts
# ---------------------------------------------------------------------------

def _timm_state(seed=0):
    """A timm ``vit_*`` state dict of the micro ViT from seeded random weights,
    and JAX's config of it."""
    jm = jax_create_model("vit_micro_test")
    v = nn.meta.unbox(jm.module.init(jax.random.key(seed), jm.example_input(1), observe=False))
    return jtc.params_to_timm_vit(jax.device_get(v["params"]), jm.cfg), jm.cfg


def test_timm_conversion_matches_jax(tmp_path):
    """``.pth`` with ``module.``, a nested ``state_dict`` and QAT stub / fake-quant
    keys: both packages read the same tree; the inverse gives the same state
    dict; bf16 tensors read as f32."""
    tm = create_model("vit_micro_test")
    state, jcfg = _timm_state()
    noisy = {f"module.{k}": torch.from_numpy(np.array(v)) for k, v in state.items()}
    noisy.update({"module.quant.scale": torch.tensor(1.0),
                  "module.blocks.0.attn.qkv.weight_fake_quant.scale": torch.tensor(0.1),
                  "module.activation_post_process.min_val": torch.tensor(0.0)})
    path = str(tmp_path / "teacher.pth")
    torch.save({"state_dict": noisy}, path)
    got = ttc.timm_vit_to_params(ttc.load_torch_state_dict(path), tm.cfg)
    want = jtc.timm_vit_to_params(jtc.load_torch_state_dict(path), jcfg)
    _same_tree(got, want)
    back = ttc.params_to_timm_vit(got, tm.cfg)
    assert sorted(back) == sorted(state)
    for k in state:
        np.testing.assert_array_equal(back[k], state[k])
    with pytest.raises(ValueError, match="unused"):
        ttc.timm_vit_to_params({**state, "extra.weight": np.zeros(1)}, tm.cfg)
    bf = {k: torch.from_numpy(np.array(v)).to(torch.bfloat16) for k, v in state.items()}
    torch.save(bf, path)
    got = ttc.timm_vit_to_params(ttc.load_torch_state_dict(path), tm.cfg)
    assert got["cls_token"].dtype == np.float32
    np.testing.assert_array_equal(got["cls_token"], bf["cls_token"].float().numpy())


@pytest.fixture(scope="module")
def hf_micro():
    import transformers as tfm

    cfg = tfm.Owlv2Config(
        text_config=dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
                         intermediate_size=128),
        vision_config=dict(hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
                           intermediate_size=256, image_size=32, patch_size=8))
    torch.manual_seed(0)
    m = tfm.Owlv2ForObjectDetection(cfg).eval()
    with torch.no_grad():
        for p in m.parameters():
            p.normal_(std=0.05)
    return {k: v.detach().numpy() for k, v in m.state_dict().items()}


GEO = dict(image_size=32, patch_size=8, embed_dim=128, depth=2, num_heads=2, mlp_ratio=2.0)


def test_owlv2_conversions_match_jax(hf_micro):
    """The vision tower and the whole detector from an HF
    ``Owlv2ForObjectDetection`` state dict, as JAX converts them."""
    from qat_vit_tpu.models.owlv2_detect import detector_config as jax_detector_config
    from qat_vit_tpu_torch.models.owlv2_detect import detector_config

    cfg, jcfg = detector_config(**GEO), jax_detector_config(**GEO)
    _same_tree(ttc.owlv2_vision_to_params(hf_micro, cfg, strict=False),
               jtc.owlv2_vision_to_params(hf_micro, jcfg, strict=False))
    got = owlv2_detection_to_params(hf_micro, cfg, text_dim=64)
    _same_tree(got, jax_owlv2_detection(hf_micro, jcfg, text_dim=64))
    det = create_model("owlv2_pruned_detector", text_dim=64, **GEO)
    load_jax_variables(det.module, got)  # every parameter of the port's detector covered
    _same_tree(state_dict_to_params(det.module.state_dict()), got)


# ---------------------------------------------------------------------------
# the trainers and the predictor
# ---------------------------------------------------------------------------

def _hp(**over):
    from qat_vit_tpu_torch.train.config import load_hparams

    hp = load_hparams(None)
    hp.update(batch_size=8, eval_batch_size=8, image_size=32, epochs=1, **over)
    return hp


def test_trainer_weights_from_files(tmp_path, monkeypatch):
    """``teacher_ckpt`` (a timm ``.pth``) and ``student_ckpt`` (a msgpack
    holding ``params``, with a key missing and one extra) load what JAX's
    ``load_model_params`` loads (the teacher cast to bf16); ``resume`` raises."""
    from qat_vit_tpu_torch.data.cifar10 import synthetic_cifar10
    from qat_vit_tpu_torch.train import trainer as tr

    def micro(name):
        return lambda family, **kw: create_model("vit_micro_test", **{
            k: v for k, v in kw.items() if k in ("dtype", "generator")},
            qat_wrapper=name == "student")

    monkeypatch.setattr(tr, "create_teacher", micro("teacher"))
    monkeypatch.setattr(tr, "create_student", micro("student"))
    state, jcfg = _timm_state(seed=3)
    tpath = str(tmp_path / "teacher.pth")
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in state.items()}, tpath)
    jm = jax_create_model("vit_micro_test")
    sparams = jax.device_get(nn.meta.unbox(jm.module.init(
        jax.random.key(5), jm.example_input(1), observe=False))["params"])
    saved = {k: v for k, v in sparams.items() if k != "cls_token"}
    saved["unexpected"] = np.zeros(3, np.float32)
    spath = str(tmp_path / "student.msgpack")
    jck.save_checkpoint(spath, {"params": saved, "quant_stats": {}})

    data = synthetic_cifar10(n_train=16, n_test=8)
    t = tr.KDQATTrainer(_hp(teacher_ckpt=tpath, student_ckpt=spath), device="cpu", data=data)
    want_t = jax_load_model_params(tpath, jcfg)
    got_t = state_dict_to_params(t.teacher.module.state_dict())
    for k, v in _flat(want_t).items():
        np.testing.assert_array_equal(
            _flat(got_t)[k], np.asarray(jnp.asarray(v, jnp.bfloat16).astype(jnp.float32)), k)
    template = state_dict_to_params(tr.KDQATTrainer(_hp(), device="cpu", data=data)
                                    .student_float.state_dict())
    want_s = jax_load_model_params(spath, jcfg, template=template)
    _same_tree(state_dict_to_params(t.student_float.state_dict()), want_s)
    np.testing.assert_array_equal(want_s["cls_token"], template["cls_token"])  # kept
    with pytest.raises(NotImplementedError, match="resume"):
        tr.KDQATTrainer(_hp(resume=spath), device="cpu", data=data)


def test_detect_trainer_overrides_and_teacher_ckpt(hf_micro, tmp_path):
    """``student=`` / ``teacher=`` are the trainer's models (the teacher cast
    to bf16); ``teacher_ckpt`` loads a JAX-written detector tree (an HF
    checkpoint converted) as JAX's trainer reads it."""
    from qat_vit_tpu.models.owlv2_detect import detector_config as jax_detector_config
    from qat_vit_tpu_torch.data.cifar10 import synthetic_cifar10
    from qat_vit_tpu_torch.train.detect_trainer import DetectKDTrainer

    hp = _hp(task="detection", text_dim=64, num_queries=2,
             **{k: v for k, v in GEO.items() if k != "image_size"})
    data = synthetic_cifar10(n_train=8, n_test=4)
    g = torch.Generator().manual_seed(7)
    student = create_model("owlv2_pruned_detector", text_dim=64, generator=g, **GEO)
    teacher = create_model("owlv2_base_detector", text_dim=64, generator=g, **GEO)
    want_s = {k: v.clone() for k, v in student.module.state_dict().items()}
    want_t = {k: v.to(torch.bfloat16) for k, v in teacher.module.state_dict().items()}
    t = DetectKDTrainer(hp, device="cpu", data=data, student=student, teacher=teacher)
    assert t.teacher is teacher
    for k, v in t.teacher.module.state_dict().items():
        assert torch.equal(v.to(torch.bfloat16), want_t[k]), k
    for k, v in t.student_float.state_dict().items():
        assert torch.equal(v, want_s[k]), k

    tree = jax_owlv2_detection(hf_micro, jax_detector_config(**GEO), text_dim=64)
    path = str(tmp_path / "teacher_det.msgpack")
    jck.save_checkpoint(path, {"params": tree})
    t = DetectKDTrainer({**hp, "teacher_ckpt": path}, device="cpu", data=data)
    want = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)),
                        jck.load_checkpoint(path)["params"])
    got = state_dict_to_params({k: v.float() for k, v in t.teacher.module.state_dict().items()})
    _same_tree(got, want)


def test_predictor_from_checkpoint_matches_jax(tmp_path):
    """The same export file served by both packages' ``from_checkpoint`` (the
    port on the CPU), in f32 (``compute_dtype`` and ``attn_dtype``, the
    predictors' own options): logits within ``test_predictor_cpu``'s tolerance
    (measured identical). At the default bf16 the packages round the stream at
    other places (1.5e-2 apart here), so there the file is held to the port's
    in-memory predictor over the same export: identical. ``w_colsum`` stays
    int32 and the 0-d qparams stay on the host."""
    jcfg, _, _, jexp = _jax_state("gelu")
    path = str(tmp_path / "best_converted.msgpack")
    jck.save_checkpoint(path, jexp)
    tm = create_model("vit_micro_test", qat_wrapper=True)
    imgs = np.random.default_rng(4).integers(0, 256, (6, 32, 32, 3), dtype=np.uint8)
    f32 = dict(compute_dtype=torch.float32, attn_dtype=torch.float32)
    pred = Int8Predictor.from_checkpoint(path, tm.cfg, device="cpu", batch_size=4, **f32)
    blk = pred.qparams["blocks"]["0"]
    assert blk["qkv"]["w_colsum"].dtype == torch.int32 and blk["qkv"]["w_int8"].dtype == torch.int8
    assert blk["qkv"]["w_scale"].ndim == 0 and blk["qkv"]["w_scale"].device.type == "cpu"
    want = JaxInt8Predictor.from_checkpoint(path, jcfg, batch_size=4, compute_dtype=jnp.float32,
                                            attn_dtype=jnp.float32).logits(imgs)
    np.testing.assert_allclose(pred.logits(imgs), want, rtol=1e-5, atol=1e-6)
    got = Int8Predictor.from_checkpoint(path, tm.cfg, device="cpu", batch_size=4).logits(imgs)
    in_memory = Int8Predictor(export_from_numpy(jexp), tm.cfg, device="cpu", batch_size=4)
    np.testing.assert_array_equal(got, in_memory.logits(imgs))
    assert os.path.isfile(path) and not os.path.exists(path + ".tmp")
