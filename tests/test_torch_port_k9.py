"""K9a / K9b, the whole-block cooperative kernels, rehearsed on the CPU.

``csrc/megablock.cu`` runs the five stages of the K4 chain (qkv PLAIN,
attention, proj RESID_LN_Q, fc1 GELU_Q, fc2 RESID_LN_Q) in one cooperative
launch, each stage on the chain kernels' own stage code (the wgmma GEMM of
K2a / K2b, K2c's row tile, K3's tensor-core attention tile) as a persistent
loop over its tiles. This file holds:

- (a) the gate: the conjunction of the chain kernels' own gates and the
  stages' shared-memory plan, over a sweep of geometries that includes the
  ones the CUDA-core design refused (901 tokens, D 480 / MLP 1,920, MLP
  1,568), and the plan's numbers at ViT-S;
- (b) a model of the persistent schedule: every tile of every stage owned
  by exactly one block, and every output element by exactly one tile, for
  the grids the launcher makes;
- (c) the per-block table's bytes and the launch arguments of both
  wrappers, against a recording stand-in for the kernel library;
- (d) K9's twin on the CPU, the chain through the plain ops with K3's
  model as its attention stage, against JAX's ``int8_apply(fused=
  "megablock:2:tight")`` and ``"megamodel_res:2:tight"`` in interpret mode.

Inputs are numpy, seeded, and go to both packages.
"""

import ctypes
from functools import partial
from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from qat_vit_tpu.serve.int8_vit import int8_apply as jax_int8_apply
from qat_vit_tpu_torch import _build
from qat_vit_tpu_torch.ops import block_kernel as bk
from qat_vit_tpu_torch.ops import fused_serve as fs
from qat_vit_tpu_torch.ops._cuda import SMEM_LIMIT
from qat_vit_tpu_torch.ops.flash_attention import _q_scale, attention_fwd_shapes_ok
from qat_vit_tpu_torch.ops.quantized_matmul import f32
from qat_vit_tpu_torch.serve.int8_vit import _embed, int8_apply, pack_gemm_weights
from tests.test_torch_port_short_tc import EXACT_REL_L2, short_k3
from tests.test_torch_port_slice import _jax_interpret
from tests.test_torch_port_slice import export  # noqa: F401 (a module fixture)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's micro models, restored after
    it: their ops are tiny, and under pytest-xdist every worker's default
    threads would contend for the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


BF16 = torch.bfloat16
# (N, heads, hd, MLP): ViT-S/16 at 224, 384 and 480 px, ViT-B/16, D 480 (5 x
# 96) with MLP 1,920, MLP 1,568 (K % 64 = 32), OWLv2's 2,305 tokens, the
# micro ViT, hd 8 and 128, and geometries past a chain kernel's gate: hd 60
# and 136, D 1,792 and 2,048 (RESID_LN_Q's N past 1,756), MLP 100 (K % 16)
SWEEP = [(n, h, hd, mlp) for n in (1, 17, 197, 577, 901, 2305)
         for h, hd, mlp in ((6, 64, 1536), (12, 64, 3072), (5, 96, 1920), (6, 64, 1568),
                            (2, 64, 512), (4, 8, 128), (3, 128, 1536), (4, 60, 960),
                            (2, 136, 1088), (14, 128, 7168), (16, 128, 8192), (6, 64, 100))]


def _gemm_region():
    # the ring (4 stages of (128 + 128) rows x 128 bytes), then per consumer
    # warpgroup the qkv stage's bf16 staging (64 x (256 + 16)) and the
    # per-column constants (3 x 4 x 128)
    return 4 * 256 * 128 + 2 * (64 * 272 + 1536)


@pytest.mark.parametrize("n,h,hd,mlp", SWEEP)
def test_gate_is_the_chain_kernels_gates(n, h, hd, mlp):
    """``megablock_shapes_ok`` is the conjunction of ``fs.gemm_shapes_ok``
    for the four GEMMs (K % 16; RESID_LN_Q's N within its plan), K3's
    ``attention_fwd_shapes_ok`` (hd % 8, hd <= 128, any N) and the stages'
    shared memory within the limit; no K % 64, no N cap from a CUDA-core
    attention tile."""
    d = h * hd
    want = (fs.gemm_shapes_ok(d, 3 * d) and fs.gemm_shapes_ok(d, d, resid_ln=True)
            and fs.gemm_shapes_ok(d, mlp) and fs.gemm_shapes_ok(mlp, d, resid_ln=True)
            and attention_fwd_shapes_ok(n, hd)
            and bk.megablock_plan(n, d, hd)[3] <= SMEM_LIMIT)
    assert bk.megablock_shapes_ok(n, h, hd, mlp) == want
    if (h, hd) in ((6, 64), (12, 64), (5, 96), (3, 128)) and mlp % 16 == 0:
        assert want, (n, h, hd, mlp)  # every N the chain takes, K9 takes


def test_gate_takes_what_the_old_design_refused():
    """ViT-S/16 at 480 px (901 tokens), D 480 / MLP 1,920 and MLP 1,568 pass;
    hd 60, hd 136, MLP 100 and D 1,792 do not."""
    assert bk.megablock_shapes_ok(901, 6, 64, 1536)
    assert bk.megablock_shapes_ok(197, 5, 96, 1920) and bk.megablock_shapes_ok(197, 6, 64, 1568)
    assert bk.megablock_shapes_ok(2305, 6, 64, 1536)
    assert not bk.megablock_shapes_ok(197, 4, 60, 960)
    assert not bk.megablock_shapes_ok(197, 2, 136, 1088)
    assert not bk.megablock_shapes_ok(197, 6, 64, 100)
    assert not bk.megablock_shapes_ok(197, 14, 128, 7168)
    assert not hasattr(bk, "MEGABLOCK_K_MULTIPLE")


def test_plan_at_vit_s():
    """The plan mirrors ``csrc/megablock.cu``: one block per SM, whose GEMM
    stages take 168,960 bytes; at ViT-S (D 384) K2c's tile takes 64 rows
    within them, K3 keeps K and V resident at 197 tokens and streams them
    at 577 and 901, and the block asks 170,048 bytes; at ViT-B (D 768) K2c
    takes 32 rows; at D 1,756 16."""
    gemm = _gemm_region()
    assert gemm == 168_960
    assert fs.resid_ln_smem_bytes(64, 384) == 168_448 <= gemm
    resident = 2 * 2 * (64 + 8) * 208  # K and V of 197 keys rounded to 208 rows
    for n, res in ((197, True), (577, False), (901, False)):
        rows, got_res, region, smem = bk.megablock_plan(n, 384, 64)
        assert (rows, got_res, region, smem) == (64, res, gemm, 1024 + gemm + 64), n
        assert smem + fs.BLOCK_SMEM_RESERVE <= fs.SM_SMEM_BYTES
    assert resident == 59_904 and bk._attention_bytes(197, 64, True) == resident
    assert bk._attention_bytes(577, 64, True) == 2 * 2 * 72 * 592 > gemm
    assert bk._attention_bytes(901, 64, False) == 2 * 72 * (128 + 6 * 64)
    assert bk._attention_bytes(197, 128, False) == 2 * 136 * (128 + 4 * 64)
    assert bk.megablock_plan(197, 768, 64)[0] == 32
    assert bk.megablock_plan(197, 1756, 4)[0] == 16
    assert bk.K9_THREADS == 256 and bk.BLOCK_TABLE_BYTES == 512


# ---------------------------------------------------------------------------
# (b) the persistent schedule
# ---------------------------------------------------------------------------

def _grids():
    # min(co-resident blocks per SM, K9_MIN_BLOCKS) x SMs, as the launcher
    # computes it, for an H100's 132 SMs and smaller cards
    return sorted({min(per_sm, bk.K9_MIN_BLOCKS) * sms for per_sm in (1, 2, 3)
                   for sms in (1, 7, 132)})


def _stage_tiles(b, n, h, hd, mlp, rows):
    """Each stage's tile count as ``csrc/megablock.cu`` walks them: the GEMMs
    over [128-row x 128-column] tiles, K3's (128 query rows, head, image)
    tiles, K2c's ``rows``-row tiles over all columns."""
    m, d = b * n, h * hd
    gemm = -(-m // bk.K9_TILE_ROWS)
    return {"qkv": gemm * -(-3 * d // bk.K9_TILE_COLS),
            "attention": -(-n // bk.ATTN_ROWS) * h * b, "proj": -(-m // rows),
            "fc1": gemm * -(-mlp // bk.K9_TILE_COLS), "fc2": -(-m // rows)}


@pytest.mark.parametrize("b,n,h,hd,mlp", [(32, 197, 6, 64, 1536), (256, 197, 6, 64, 1536),
                                          (8, 901, 6, 64, 1536), (3, 17, 2, 64, 512),
                                          (2, 197, 5, 96, 1920)])
def test_every_tile_owned_once(b, n, h, hd, mlp):
    """Each stage's tile t runs on block t mod grid (``range(block, tiles,
    grid)`` in every block): owned by exactly one block; the GEMM tiles
    ([128 rows x 128 columns], row-major) cover the [M, N] output once, K3's
    (128 query rows, head, image) tiles every (query, head, image) once,
    K2c's row tiles every row once."""
    m, d = b * n, h * hd
    rows = bk.megablock_plan(n, d, hd)[0]
    tiles = _stage_tiles(b, n, h, hd, mlp, rows)
    for grid in _grids():
        for stage, count in tiles.items():
            owner = np.zeros(count, np.int64)
            for block in range(grid):
                owner[list(range(block, count, grid))] += 1
            assert (owner == 1).all(), (stage, grid)
    for stage, width in (("qkv", 3 * d), ("fc1", mlp)):
        cover = np.zeros((m, width), np.int8)
        n_tiles = -(-width // bk.K9_TILE_COLS)
        for t in range(tiles[stage]):
            m0, n0 = (t // n_tiles) * bk.K9_TILE_ROWS, (t % n_tiles) * bk.K9_TILE_COLS
            cover[m0:m0 + bk.K9_TILE_ROWS, n0:n0 + bk.K9_TILE_COLS] += 1
        assert (cover == 1).all(), stage
    cover = np.zeros((b, h, n), np.int8)
    nq = -(-n // bk.ATTN_ROWS)
    for t in range(tiles["attention"]):
        q0 = (t % nq) * bk.ATTN_ROWS
        cover[t // (nq * h), (t // nq) % h, q0:q0 + bk.ATTN_ROWS] += 1
    assert (cover == 1).all()
    for stage in ("proj", "fc2"):
        cover = np.zeros(m, np.int8)
        for t in range(tiles[stage]):
            cover[t * rows:(t + 1) * rows] += 1
        assert (cover == 1).all(), stage


# ---------------------------------------------------------------------------
# (c) the table and the launch arguments
# ---------------------------------------------------------------------------

class _Recorder:
    """A stand-in kernel library: records each entry point's arguments and,
    at ``qvt_megablock``, the table's bytes behind its pointer."""

    def __init__(self):
        self.calls = []
        self.tables = []

    def call(self, name, *args):
        assert len(args) == len(_build._SIGNATURES[name]), (name, len(args))
        self.calls.append((name, args))
        if name == "qvt_megablock":
            self.tables.append(ctypes.string_at(args[0], args[1] * bk.BLOCK_TABLE_BYTES))


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(_build, "load", lambda: rec)
    monkeypatch.setattr(bk, "use_plain", lambda t: False)
    monkeypatch.setattr(bk, "stream_of", lambda dev: 0)
    # the table stays on the CPU (no pinned memory without a card)
    monkeypatch.setattr(bk, "_upload",
                        lambda data, dev: torch.frombuffer(bytearray(data), dtype=torch.uint8))
    return rec


def _expected_record(blk, nxt, d):
    """The 20 pointers and 24 scalars ``_BLOCK_TABLE`` packs for one block."""
    ptrs, scalars = [], {"ws0": [], "pc": [], "s_x": [], "z_s": []}
    for name, in_q in (("qkv", blk["norm1"]["out_q"]), ("proj", blk["qkv"]["out_q"]),
                       ("fc1", bk._recip_scale_q(blk["norm2"]["out_q"])),
                       ("fc2", bk._recip_scale_q(blk["gelu_q"]))):
        layer = blk[name]
        per_channel = layer["w_scale"].ndim > 0
        ptrs += [layer["w_int8_t"].data_ptr(), layer["w_colsum"].data_ptr(),
                 layer["bias"].data_ptr() if layer.get("bias") is not None else 0,
                 layer["w_scale"].data_ptr() if per_channel else 0]
        scalars["ws0"].append(0.0 if per_channel else f32(layer["w_scale"]))
        scalars["pc"].append(int(per_channel))
        scalars["s_x"].append(f32(in_q["scale"]))
        scalars["z_s"].append(int(f32(in_q["zero_point"])) - 128)
    ptrs += [blk["norm2"]["scale"].data_ptr(), blk["norm2"]["bias"].data_ptr(),
             nxt["scale"].data_ptr(), nxt["bias"].data_ptr()]
    grids = []
    for q in (blk["qkv"]["out_q"], blk["norm2"]["out_q"], blk["gelu_q"], nxt["out_q"]):
        grids += [fs.inv_scale(q["scale"]), f32(q["zero_point"])]
    return ptrs, scalars, grids


def test_table_and_launch_arguments(export, recorder):  # noqa: F811
    """What both wrappers hand the kernel library (CPU tensors, a recording
    library): per block two ``qvt_megablock_weight_map`` calls (the packed
    qkv [3D, D] and fc1 [MLP, D] weights) into the record's first 256
    bytes, then one ``qvt_megablock`` with the table (512 bytes a block:
    the packed weights' pointers, LN2 and the next LN, the GEMMs' scales and
    zero shifts, the four output grids), the stream tensors, the five
    workspace slices (256-byte aligned, in order), the geometry, the x
    dtype and the bf16 q scale; one launch each; a layer
    without its packed weight raises before any launch."""
    _, tcfg, _, qp_t, x_img = export
    qp = pack_gemm_weights(qp_t)
    x = _embed(qp, torch.from_numpy(x_img[:3]), tcfg, BF16, fs.int8_dense_plain)
    blk0 = qp["blocks"]["0"]
    zq = fs.ln_quantize_plain(x, blk0["norm1"], blk0["norm1"]["out_q"])
    b, n, d = x.shape
    h, hd, mlp, depth = tcfg.num_heads, tcfg.head_dim, tcfg.mlp_dim, tcfg.depth
    kw = dict(num_heads=h, head_dim=hd, eps=tcfg.layer_norm_eps, n_valid=n - 2)
    before = bk.megablock_forward.launches, bk.megamodel_res_forward.launches
    bk.megablock_forward(zq, x, blk0, qp["blocks"]["1"]["norm1"], **kw)
    bk.megamodel_res_forward(zq, x, qp["blocks"], qp["norm"], depth=depth, **kw)
    assert (bk.megablock_forward.launches, bk.megamodel_res_forward.launches) == (
        before[0] + 1, before[1] + 1)
    names = [c[0] for c in recorder.calls]
    assert names == (["qvt_megablock_weight_map"] * 2 + ["qvt_megablock"]
                     + ["qvt_megablock_weight_map"] * 2 * depth + ["qvt_megablock"])
    launches = [args for name, args in recorder.calls if name == "qvt_megablock"]
    for (args, blocks), table in zip(((launches[0], 1), (launches[1], depth)),
                                     recorder.tables):
        assert args[1] == blocks and len(table) == 512 * blocks
        assert args[2:4] == (zq.data_ptr(), x.data_ptr())
        ws = args[6:11]
        sizes = (b * n * 3 * d * 2, b * n * d, b * n * d * 4, b * n * d)
        assert all(p % 256 == ws[0] % 256 for p in ws)
        assert [q - p for p, q in zip(ws, ws[1:])] == [-(-s // 256) * 256 for s in sizes]
        assert args[11:18] == (b, n, h, hd, mlp, n - 2, 1)
        assert args[18:21] == (float(_q_scale(hd, BF16)), 255.0, tcfg.layer_norm_eps)
        for i in range(blocks):
            rec = table[512 * i + 256:512 * (i + 1)]
            got = bk._BLOCK_TABLE.unpack(rec)
            nxt = qp["blocks"][str(i + 1)]["norm1"] if i + 1 < depth else qp["norm"]
            ptrs, sc, grids = _expected_record(qp["blocks"][str(i)], nxt, d)
            assert list(got[:20]) == ptrs
            assert list(got[24:28]) == sc["pc"] and list(got[32:36]) == sc["z_s"]
            assert np.array_equal(np.float32(got[20:24]), np.float32(sc["ws0"]))
            assert np.array_equal(np.float32(got[28:32]), np.float32(sc["s_x"]))
            assert np.array_equal(np.float32(got[36:44]), np.float32(grids))
    maps = [args for name, args in recorder.calls if name == "qvt_megablock_weight_map"]
    assert maps[0][:3] == (blk0["qkv"]["w_int8_t"].data_ptr(), 3 * d, d)
    assert maps[1][:3] == (blk0["fc1"]["w_int8_t"].data_ptr(), mlp, d)
    assert maps[1][3] - maps[0][3] == 128
    calls = len(recorder.calls)
    bare = dict(blk0, qkv={k: v for k, v in blk0["qkv"].items() if k != "w_int8_t"})
    with pytest.raises(ValueError, match="w_int8_t"):
        bk.megablock_forward(zq, x, bare, qp["blocks"]["1"]["norm1"], **kw)
    with pytest.raises(ValueError, match="unsupported"):  # hd 4: past K3's gate
        bk.megablock_forward(zq, x, blk0, qp["blocks"]["1"]["norm1"],
                             **{**kw, "num_heads": d // 4, "head_dim": 4})
    assert len(recorder.calls) == calls


# ---------------------------------------------------------------------------
# (d) K9's twin against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["megablock:2:tight", "megamodel_res:2:tight"])
def test_twin_with_the_k3_model_matches_jax(export, monkeypatch, mode):  # noqa: F811
    """K9's plain twin, the chain through the plain ops with K3's model (the
    two passes of ``test_torch_port_short_tc``) as its attention stage, as
    K9 runs K3's tile: against JAX's whole-block kernels run as one jitted
    interpret call, logits within the exact-path bound's rel L2 (the bound
    ``test_torch_port_short_tc`` holds the megamodel chain on K3's model
    to) and the same top-1; the model ran once per block."""
    jcfg, tcfg, qp_np, qp_t, x = export
    calls = []

    def attention(qkv, h, hd, *, out_q, quant_max=255.0, n_valid=None):
        calls.append(qkv.shape)
        return short_k3(qkv, h, hd, out_q, quant_max, n_valid)

    monkeypatch.setattr(bk, "PLAIN_OPS", SimpleNamespace(**{**vars(bk.PLAIN_OPS),
                                                            "attention": attention}))
    want = np.asarray(_jax_interpret(
        partial(jax_int8_apply, cfg=jcfg, compute_dtype=jnp.bfloat16, fused=mode),
        jax.tree.map(jnp.asarray, qp_np), jnp.asarray(x)))
    got = int8_apply(qp_t, torch.from_numpy(x), tcfg, compute_dtype=BF16, fused=mode).numpy()
    assert len(calls) == tcfg.depth and got.shape == want.shape
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= EXACT_REL_L2
    assert (got.argmax(-1) == want.argmax(-1)).all()
