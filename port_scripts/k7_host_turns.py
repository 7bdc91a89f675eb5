"""K7's cost per call through its wrapper, two checkouts of the port in turns on one card.

For each checkout in the order parent, change, change, parent, a fresh process that
imports the package from that checkout, builds its kernels and times
``ops.pallas_gemm.fused_quantize_matmul`` at the exact path's five batch-32 shapes
(patch [6272, 768] @ [768, 384], qkv [6304, 384] @ [384, 1152], proj @ [384, 384],
fc1 @ [384, 1536], fc2 [6304, 1536] @ [1536, 384]), f32 and bf16 x, per-tensor
weight scale, f32 out, with the packed weight ``w_t`` where the wrapper takes it (as
``quantized_dense`` passes it):

- host us per call: ``time.perf_counter`` around each of 300 calls with no
  synchronisation (the card keeps up, so each reading is the wrapper's host work), the
  median;
- host us per call of the C entry point alone (``qvt_quantize_gemm`` through ctypes,
  the wrapper's arguments prepared once), the median of 300;
- ms per call over 10 back-to-back calls by CUDA events (chip_smoke.py's
  ``KERNEL_REPS`` reading), the median of 30;
- device ms per call under torch.profiler (20 calls).

Prints the card's name and power limit, a line per process and a JSON line of all.

    python3 port_scripts/k7_host_turns.py PARENT_DIR CHANGE_DIR
"""
import inspect
import json
import os
import statistics
import subprocess
import sys
import time

SHAPES = [("patch", 32 * 196, 768, 384), ("qkv", 32 * 197, 384, 1152),
          ("proj", 32 * 197, 384, 384), ("fc1", 32 * 197, 384, 1536),
          ("fc2", 32 * 197, 1536, 384)]
CALLS = 300


def child(root):
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from qat_vit_tpu_torch import _build
    from qat_vit_tpu_torch.ops import fused_serve as fs
    from qat_vit_tpu_torch.ops import pallas_gemm as pg

    dev = torch.device("cuda")
    takes_wt = "w_t" in inspect.signature(pg.fused_quantize_matmul).parameters
    rng = np.random.default_rng(14)
    stream = torch.cuda.current_stream().cuda_stream
    lib = _build.load()
    out = {}
    for name, m, k, n in SHAPES:
        w = np.clip(np.round(rng.normal(0, 20, (k, n))), -128, 127).astype(np.int8)
        w_q = torch.from_numpy(w).to(dev)
        w_t = torch.from_numpy(np.ascontiguousarray(w.T)).to(dev)
        colsum = torch.from_numpy(w.astype(np.int32).sum(0, dtype=np.int32)).to(dev)
        bias = torch.from_numpy(rng.normal(0, 0.5, n).astype(np.float32)).to(dev)
        kw = dict(x_scale=torch.tensor(4.0 / 255), x_zero_point=torch.tensor(100.0),
                  w_scale=torch.tensor(0.002), w_colsum=colsum, bias=bias)
        if takes_wt:
            kw["w_t"] = w_t
        for x_dt in (torch.float32, torch.bfloat16):
            x = torch.from_numpy(rng.normal(0, 1.5, (m, k)).astype(np.float32)).to(dev).to(x_dt)
            y = torch.empty(m, n, device=dev)
            s_x = float(np.float32(4.0 / 255))
            args = (x.data_ptr(), (w_t if takes_wt else w_q).data_ptr(), colsum.data_ptr(),
                    bias.data_ptr(), None, y.data_ptr(), m, n, k, int(x_dt == torch.bfloat16), 0,
                    0, float(np.float32(0.002)), s_x, 100 - 128, fs.inv_scale(s_x), 100.0,
                    255.0, stream)

            def wrapper():
                return pg.fused_quantize_matmul(x, w_q, **kw)

            def entry():
                lib.call("qvt_quantize_gemm", *args)

            if not torch.equal(wrapper(), (entry(), y)[1]):
                sys.exit(f"{name}: the wrapper and the entry point differ")
            row = {}
            for label, fn in (("wrapper", wrapper), ("entry", entry)):
                for _ in range(20):
                    fn()
                torch.cuda.synchronize()
                ts = []
                for _ in range(CALLS):
                    t0 = time.perf_counter()
                    fn()
                    ts.append(time.perf_counter() - t0)
                torch.cuda.synchronize()
                row[f"{label}_host_us"] = statistics.median(ts) * 1e6
            ts = []
            for _ in range(30):
                s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                s.record()
                for _ in range(10):
                    wrapper()
                e.record()
                e.synchronize()
                ts.append(s.elapsed_time(e) / 10)
            row["b2b_ms"] = statistics.median(ts)
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                for _ in range(20):
                    wrapper()
                torch.cuda.synchronize()
            row["device_ms"] = sum(ev.time_range.elapsed_us() for ev in prof.events()
                                   if ev.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / 20
            out[f"{name} {'f32' if x_dt == torch.float32 else 'bf16'}"] = row
    print("RESULT " + json.dumps(out), flush=True)


def main():
    parent, change = (os.path.abspath(p) for p in sys.argv[1:3])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    runs = []
    for who, root in (("parent", parent), ("change", change), ("change", change),
                      ("parent", parent)):
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root],
                           cwd=root, capture_output=True, text=True)
        res = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT ")]
        if r.returncode or not res:
            sys.exit(f"{who} failed (rc {r.returncode}):\n{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
        rows = json.loads(res[0][len("RESULT "):])
        runs.append([who, rows])
        print(f"{who}: " + "; ".join(
            f"{case} host {v['wrapper_host_us']:.1f} us (entry {v['entry_host_us']:.1f}), "
            f"10 back to back {v['b2b_ms']:.4f} ms, device {v['device_ms']:.4f}"
            for case, v in rows.items()), flush=True)
    print(json.dumps({"card": card, "runs": runs}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        child(sys.argv[2])
    else:
        main()
