"""Builds of K2d (``csrc/ln_quantize.cu``) with parts of the design changed, timed in one process.

    python3 port_scripts/k2d_variants.py [--parent DIR] [variant ...]

Each variant is the source text-patched (``VARIANTS``: no f64 copies of a row's values,
f64 copies for f32 rows too, 8 or 2 warps per block, the per-row statistics by f64
divisions and square root, or as ``* (1 / N)`` and ``rsqrt``) and built by its own nvcc into its own library; with
``--parent DIR`` also the parent's ``ln_quantize.cu`` (its three-pass kernel). Each is
called through ctypes at ``SHAPES`` (bf16 and f32 where listed), held bit-identical to
``ops.fused_serve.ln_quantize_plain``, and timed by device time under torch.profiler (20
launches per shape, variants in turns: the list, then again in reverse). ``ABLATIONS``
are patches that drop a piece of the work (f64 sums, the per-row f64 arithmetic, the
stores): timed, not checked. Prints the card's name and power limit, the ptxas
registers of each build, a line per variant and a JSON line of all.
"""
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)

STATS_CALL = "const float2 st = qvt::row_stats_f64(s, n, inv_n, eps, [&](double mean) {"
ROW_HEAD = "// one row of the register form"


def _row_stats(name, body):
    """A patch that puts a statistics helper ``name`` (``body``: its statements,
    from the lane sum ``s``, ``n``, ``inv_n``, ``eps`` and ``var_part``) before
    ``ln_row``."""
    return (ROW_HEAD, "template <typename S, typename VarPart>\n"
            f"__device__ __forceinline__ float2 {name}(S s, int n, double inv_n, float eps, "
            "VarPart var_part) {\n" + body + "}\n\n" + ROW_HEAD)


# variants: (old, new) text patches of the source, each found exactly once
VARIANTS = {
    "design": [],
    "no_f64_cache": [("constexpr int CACHE_SLOTS = 24;", "constexpr int CACHE_SLOTS = 0;")],
    "f64_cache_f32": [("constexpr bool CACHE = sizeof(T) == 2 && NV * E <= CACHE_SLOTS;",
                       "constexpr bool CACHE = NV * E <= CACHE_SLOTS;")],
    "warps8": [("constexpr int REG_WARPS = 4;", "constexpr int REG_WARPS = 8;")],
    "warps2": [("constexpr int REG_WARPS = 4;", "constexpr int REG_WARPS = 2;")],
    "div_sqrt": [_row_stats("stats_div_sqrt",
                            "  const double mean = qvt::warp_sum(s) / n;\n"
                            "  const double var = qvt::warp_sum(var_part(mean)) / n;\n"
                            "  return make_float2(static_cast<float>(mean), static_cast<float>("
                            "1.0 / sqrt(var + static_cast<double>(eps))));\n"),
                 (STATS_CALL, STATS_CALL.replace("qvt::row_stats_f64", "stats_div_sqrt"))],
    "mul_rsqrt": [_row_stats("stats_mul_rsqrt",
                             "  const double mean = qvt::warp_sum(s) * (1.0 / n);\n"
                             "  const double var = qvt::warp_sum(var_part(mean)) * (1.0 / n);\n"
                             "  return make_float2(static_cast<float>(mean), static_cast<float>("
                             "rsqrt(var + static_cast<double>(eps))));\n"),
                  (STATS_CALL, STATS_CALL.replace("qvt::row_stats_f64", "stats_mul_rsqrt"))],
}
# ablations: patches that drop a piece of the work (results not checked: they are
# not K2d), to see what bounds the kernel
ABLATIONS = {
    "abl_f32_sums": [_row_stats("stats_f32",
                                "  const float mean = qvt::warp_sum(s) / n;\n"
                                "  const float var = qvt::warp_sum(var_part(mean)) / n;\n"
                                "  return make_float2(mean, rsqrtf(var + eps));\n"),
                     ("double s = 0.0;", "float s = 0.0f;"),
                     ("double xd[CACHE", "float xd[CACHE"),
                     ("const double d = static_cast<double>(f[v][e]);", "const float d = f[v][e];"),
                     (STATS_CALL, "const float2 st = stats_f32(s, n, inv_n, eps, [&](float mean) {"),
                     ("double var = 0.0;", "float var = 0.0f;"),
                     ("          double d;\n", "          float d;\n"),
                     ("d = static_cast<double>(f[v][e]) - mean;", "d = f[v][e] - mean;")],
    "abl_f32_row": [_row_stats("stats_f32_row",
                               "  const float mean = static_cast<float>(qvt::warp_sum(s)) / n;\n"
                               "  const float var = static_cast<float>(qvt::warp_sum(var_part(mean)))"
                               " / n;\n"
                               "  return make_float2(mean, rsqrtf(var + eps));\n"),
                    (STATS_CALL, STATS_CALL.replace("qvt::row_stats_f64", "stats_f32_row"))],
    "abl_no_store": [("      if constexpr (E == 8)\n        *reinterpret_cast<uint2*>(dst)",
                      "      if (packed[0] == 0x12345678u) {}\n      else if constexpr (E == 8)"
                      "\n        *reinterpret_cast<uint2*>(dst)")],
}
# (rows, width, dtypes)
SHAPES = [(50432, 384, ("bf16", "f32")), (6304, 384, ("bf16",)), (18440, 576, ("bf16", "f32")),
          (6304, 768, ("bf16",)), (6304, 1024, ("bf16", "f32"))]
CALLS = 20


def build(src_dir, out, patches=()):
    """Start nvcc on ``src_dir``'s ln_quantize.cu (text-patched by ``patches``, each
    (old, new) pair found exactly once); :func:`registers` waits for it."""
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    src = os.path.join(src_dir, "ln_quantize.cu")
    if patches:
        text = open(src).read()
        for old, new in patches:
            if text.count(old) != 1:
                sys.exit(f"patch {old!r}: found {text.count(old)} times")
            text = text.replace(old, new)
        src = out[:-3] + ".cu"
        with open(src, "w") as f:
            f.write(text)
    return subprocess.Popen([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                             "-O3", "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v",
                             "-I", src_dir, src, "-o", out],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def registers(proc):
    """The registers ptxas reports per kernel, once the build has ended."""
    _, err = proc.communicate()
    if proc.returncode:
        sys.exit(f"build {proc.args} failed:\n{err[-3000:]}")
    return [ln.split("Used ")[1].split(",")[0] for ln in err.splitlines() if "Used " in ln]


def main():
    import numpy as np
    import torch

    from qat_vit_tpu_torch.ops import fused_serve as fs

    args = sys.argv[1:]
    parent = None
    if "--parent" in args:
        i = args.index("--parent")
        parent = os.path.abspath(args[i + 1])
        del args[i:i + 2]
    names = args or list(VARIANTS) + list(ABLATIONS)
    ablations = [n for n in names if n in ABLATIONS]
    names = [n for n in names if n not in ABLATIONS]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    tmp = tempfile.mkdtemp()
    src = os.path.join(ROOT, "qat_vit_tpu_torch", "csrc")
    builds = {name: build(src, os.path.join(tmp, f"{name}.so"), {**VARIANTS, **ABLATIONS}[name])
              for name in names + ablations}
    if parent:
        builds["parent"] = build(os.path.join(parent, "qat_vit_tpu_torch", "csrc"),
                                 os.path.join(tmp, "parent.so"))
    libs = {}
    for name, proc in builds.items():
        regs = registers(proc)
        print(f"{name}: registers {' '.join(regs)}", flush=True)
        libs[name] = ctypes.CDLL(os.path.join(tmp, f"{name}.so"))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, lib in libs.items():
        lib.qvt_ln_quantize.argtypes = [P] * 4 + [I] * 3 + [F] * 4 + [P]
        lib.qvt_ln_quantize.restype = I

    dev = torch.device("cuda")
    out_q = {"scale": torch.tensor(8.0 / 255), "zero_point": torch.tensor(128.0)}
    inv_s, zp = fs.inv_scale(out_q["scale"]), 128.0
    stream = torch.cuda.current_stream().cuda_stream
    cases = []
    for m, n, dts in SHAPES:
        r = np.random.default_rng(m + n)
        x32 = r.normal(0.3, 1.5, (m, n)).astype(np.float32)
        ln = {"scale": torch.from_numpy(r.normal(1, 0.2, n).astype(np.float32)).to(dev),
              "bias": torch.from_numpy(r.normal(0, 0.2, n).astype(np.float32)).to(dev)}
        for dt in dts:
            x = torch.from_numpy(x32).to(dev).to(torch.bfloat16 if dt == "bf16" else torch.float32)
            want = fs.ln_quantize_plain(x, ln, out_q)
            cases.append((f"[{m}x{n}] {dt}", x, ln, want))

    def launch(name, x, ln, q):
        m, n = x.shape
        bf = int(x.dtype == torch.bfloat16)
        err = libs[name].qvt_ln_quantize(x.data_ptr(), ln["scale"].data_ptr(),
                                         ln["bias"].data_ptr(), q.data_ptr(), m, n, bf, inv_s,
                                         zp, 255.0, 1e-6, stream)
        if err:
            sys.exit(f"{name}: launch error {err}")

    for name in libs:
        if name in ABLATIONS:
            continue
        for label, x, ln, want in cases:
            q = torch.empty_like(want)
            launch(name, x, ln, q)
            torch.cuda.synchronize()
            if not torch.equal(q, want):
                sys.exit(f"{name} {label}: not identical to the plain version")
    print("every build but the ablations identical to the plain version at every shape",
          flush=True)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    times = {name: {label: [] for label, *_ in cases} for name in libs}
    order = list(libs)
    for turn in (order, order[::-1]):
        for name in turn:
            qs = [torch.empty_like(want) for *_, want in cases]
            for (label, x, ln, _), q in zip(cases, qs):
                launch(name, x, ln, q)
            torch.cuda.synchronize()
            # the profiler now and then drops a device event: such a session is
            # taken again, at most three times
            for _ in range(3):
                with torch.profiler.profile(activities=acts) as prof:
                    for (label, x, ln, _), q in zip(cases, qs):
                        for _ in range(CALLS):
                            launch(name, x, ln, q)
                    torch.cuda.synchronize()
                evs = sorted((e for e in prof.events()
                              if e.device_type == torch.autograd.DeviceType.CUDA),
                             key=lambda e: e.time_range.start)
                if len(evs) == CALLS * len(cases):
                    break
                print(f"{name}: {len(evs)} device events, expected {CALLS * len(cases)}; "
                      "again", flush=True)
            else:
                sys.exit(f"{name}: {len(evs)} device events, expected {CALLS * len(cases)}")
            for i, (label, *_) in enumerate(cases):
                us = [e.time_range.elapsed_us() for e in evs[i * CALLS:(i + 1) * CALLS]]
                times[name][label].append(statistics.median(us) / 1e3)
    for name in libs:
        print(f"{name}: device ms per call (two turns) " + "; ".join(
            f"{label} {' / '.join(f'{t:.4f}' for t in ts)}" for label, ts in times[name].items()),
            flush=True)
    print(json.dumps({"card": card, "times": times}), flush=True)


if __name__ == "__main__":
    main()
