"""Variants of the f32 kernels A and B (csrc/attention_f32.cu) timed on the card in
one process: each variant is the source with text patches, built by its own nvcc
into its own library (registers and spills printed), checked bit for bit against
the unpatched build where it keeps the arithmetic (`sound`), and timed launch by
launch (kernel A, kernel B's rows and keys passes) at ViT-S [256, 197, 1152] and
[2, 512, 2304], in_fq off and on: CUDA events around 10 back-to-back launches,
median of 10, two rounds in opposite orders. Ablations (not sound) show where the
time goes: the f64 exp or division made cheap, a micro-GEMM skipped.

    python3 port_scripts/k1f32_variants.py [VARIANT ...]
"""
import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
from qat_vit_tpu_torch import _build  # noqa: E402

SRC = "attention_f32.cu"
EXP = "return static_cast<float>(exp(static_cast<double>(__fsub_rn(s, m))));"
LB = "__launch_bounds__(THREADS, 2)"
# name: (patches, sound)
VARIANTS = {
    "base": ([], True),
    "noexp": ([(EXP, "return __expf(__fsub_rn(s, m));")], False),
    "nodiv": ([("static_cast<double>(sr[j]) / l", "static_cast<double>(sr[j]) * l"),
               ("/ Lt[c]", "* Lt[c]")], False),
    "nog1": ([("if (r0 >= rows || c0 >= cols) return;", "return;")], False),
    "nog2": ([("if (map.act) g2<", "if (false) g2<")], False),
    "lb2": ([("__launch_bounds__(THREADS, MR == 2 ? 3 : 2)", LB)], True),
    "rows3": ([(LB, "__launch_bounds__(THREADS, 3)")], True),
    # the rest of each pass, one piece at a time: the staging of sweep 1's K and V
    # tiles (rows), of sweep 2's K tiles (rows), of the q and do tiles (keys); the
    # row softmax (A), the row statistics (rows), the elementwise p^T / ds^T (keys)
    "nostage1": ([("    stage(Ks, ld, img + D + k0 * stride, stride, KT, nk, hd, kv);\n"
                   "    stage(Vs, ld, img + 2 * D + k0 * stride, stride, KT, nk, hd, kv);\n", "")],
                 False),
    "nostage2": ([("    stage(Ks, ld, img + D + k0 * stride, stride, 2 * KT, min(2 * KT, N - k0), hd, "
                   "kv);\n", "")], False),
    "noqstage": ([("    stage(Qt, ld, img + q0 * stride, stride, QT, nq, hd, kv);\n", "")], False),
    "nosoft": ([("r < rows; r += WARPS) {  // softmax", "r < 0; r += WARPS) {  // softmax"),
                ("r < rows; r += WARPS) {  // statistics", "r < 0; r += WARPS) {  // statistics"),
                ("t < C_KEYS * QT; t += THREADS) {  // p^T", "t < 0; t += THREADS) {  // p^T")],
               False),
    "su8": ([("constexpr int SU = 4;", "constexpr int SU = 8;")], True),
}
ENTRIES = ("qvt_attention_fwd", "qvt_attention_bwd_rows", "qvt_attention_bwd_keys")


def build_all(tmp, variants):
    nvcc, procs, libs = _build._nvcc(), [], {}
    for name, (patches, _) in variants.items():
        d = os.path.join(tmp, name)
        shutil.copytree(_build.CSRC, d)
        p = os.path.join(d, SRC)
        text = open(p).read()
        for old, new in patches:
            assert old in text, (name, old)
            text = text.replace(old, new)
        open(p, "w").write(text)
        libs[name] = os.path.join(d, "lib.so")
        procs.append(subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
                                       "-I", d, "-o", libs[name], p],
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    out = {}
    for name, proc in zip(variants, procs):
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: {err[-3000:]}")
        regs = [ln.split("Used ")[1].split(",")[0] for ln in err.splitlines() if "Used " in ln]
        spills = sorted({ln.strip() for ln in err.splitlines()
                         if "spill" in ln and " 0 bytes spill" not in ln})
        print(f"{name}: registers {regs} {spills}", flush=True)
        lib = ctypes.CDLL(libs[name])
        for e in ENTRIES:
            getattr(lib, e).argtypes = _build._SIGNATURES[e]
            getattr(lib, e).restype = ctypes.c_int
        out[name] = lib
    return out


def main():
    names = [a for a in sys.argv[1:] if a in VARIANTS]
    variants = {k: v for k, v in VARIANTS.items() if k == "base" or k in names or not names}
    dev = torch.device("cuda")
    qs = torch.tensor([4.2 / 255, 127.0], dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    card = cs.card_line()
    print(card, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_all(tmp, variants)
        for b, n, h, hd in ((256, 197, 6, 64), (2, 512, 6, 128)):
            rng = np.random.default_rng(n)
            qkv = torch.from_numpy(rng.normal(0, 1, (b, n, 3 * h * hd)).astype(np.float32)).to(dev)
            do = torch.from_numpy(rng.normal(0, 1, (b, n, h * hd)).astype(np.float32)).to(dev)
            scale_a = float(torch.tensor(hd ** -0.5, dtype=torch.float32))
            for fq in (0, 1):
                qp = qs.data_ptr() if fq else None

                def launches(lib, out, dq, st):
                    return {
                        "A": lambda: lib.qvt_attention_fwd(
                            qkv.data_ptr(), qp, out.data_ptr(), b, n, h, hd, n, scale_a, fq, 0.0,
                            255.0, stream),
                        "rows": lambda: lib.qvt_attention_bwd_rows(
                            qkv.data_ptr(), do.data_ptr(), qp, st.data_ptr(), dq.data_ptr(), b, n,
                            h, hd, n, scale_a, fq, 0.0, 255.0, stream),
                        "keys": lambda: lib.qvt_attention_bwd_keys(
                            qkv.data_ptr(), do.data_ptr(), qp, st.data_ptr(), dq.data_ptr(), b, n,
                            h, hd, n, scale_a, fq, 0.0, 255.0, stream)}

                results, ref, bufs = {}, None, {}
                for name, lib in libs.items():
                    out = torch.empty(b, n, h * hd, device=dev)
                    dq = torch.empty_like(qkv)
                    st = torch.empty(3, b, h, n, dtype=torch.float64, device=dev)
                    fns = launches(lib, out, dq, st)
                    for f in fns.values():
                        assert f() == 0
                    torch.cuda.synchronize()
                    bufs[name] = (fns, (out.clone(), dq.clone()))
                    if name == "base":
                        ref = bufs[name][1]
                order = list(libs) + list(libs)[::-1]
                for name in order:
                    fns = bufs[name][0]
                    for k, f in fns.items():
                        t = cs.median_ms(f, runs=10, reps=10)
                        results.setdefault(name, {}).setdefault(k, []).append(t)
                for name in libs:
                    got = bufs[name][1]
                    same = torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
                    r = results[name]
                    print(f"[{b}x{n}x{3 * h * hd}] {'in_fq' if fq else 'float'} {name}"
                          f"{' (sound)' if variants[name][1] else ''}: identical to base {same}; "
                          + ", ".join(f"{k} {' / '.join(f'{v:.4f}' for v in vs)} ms"
                                      for k, vs in r.items())
                          + f"; B {sum(min(v) for k, v in r.items() if k != 'A'):.4f}", flush=True)
                    if variants[name][1] and not same:
                        sys.exit(f"{name} changes the bits")
    print(f"done on {card}", flush=True)


if __name__ == "__main__":
    main()
