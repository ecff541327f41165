"""What ``torch.profiler`` costs on the card, by stage: entering the
profile, the profiled work (chains of small elementwise kernels), leaving
it, reading its raw events, one pass over them, and ``prof.events()``;
with the CPU and CUDA activities and with CUDA alone.

    python3 chip_profiler_cost.py

Needs one NVIDIA GPU.  ``chip_smoke.py``'s ``device_profile`` follows what
this shows: the CUDA activity alone, read from the raw events."""
import time

import torch
from torch.profiler import ProfilerActivity as A
from torch.profiler import profile


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_profiler_cost: needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    x = torch.randn(256, 256, device=dev)

    def work(n):
        y = x
        for _ in range(n):
            y = torch.tanh(y * 0.5 + 0.1)
        torch.cuda.synchronize()
    work(100)
    cuda = torch.autograd.DeviceType.CUDA
    for acts, name in (([A.CPU, A.CUDA], "cpu+cuda"), ([A.CUDA], "cuda"),
                       ([A.CPU, A.CUDA], "cpu+cuda again")):
        for n in (2000, 20000):
            t0 = time.perf_counter()
            p = profile(activities=acts)
            p.__enter__()
            t1 = time.perf_counter()
            work(n)
            t2 = time.perf_counter()
            p.__exit__(None, None, None)
            t3 = time.perf_counter()
            ev = p.profiler.kineto_results.events()
            t4 = time.perf_counter()
            nk = sum(1 for e in ev if e.device_type() == cuda)
            nl = sum(1 for e in ev if e.name() == "cudaLaunchKernel")
            t5 = time.perf_counter()
            if n == 2000:
                p.events()
            t6 = time.perf_counter()
            print(f"{name} n={n}: enter {t1 - t0:.3f} s, work {t2 - t1:.3f}"
                  f" s, exit {t3 - t2:.3f} s, raw events {t4 - t3:.3f} s "
                  f"({len(ev)}: {nk} on the device, {nl} launch calls), a "
                  f"pass over them {t5 - t4:.3f} s, prof.events() "
                  f"{t6 - t5:.3f} s" + ("" if n == 2000 else " (not run)"),
                  flush=True)
    print(torch.cuda.get_device_name(0))


if __name__ == "__main__":
    main()
