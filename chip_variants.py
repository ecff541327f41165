#!/usr/bin/env python3
"""K8 and K9 beside the designs their sources left behind, on one NVIDIA GPU.

    python3 chip_variants.py

Times, by CUDA events behind a spin kernel (median of 20), at the main
paths' shapes:

* K8 (paged decode attention) at nemotron-4-15b's decode layer (q 1 or 8 x
  48 x 128 bf16, 8 kv heads, pages of 128, 32k-token caches): the TMA route
  as it launches (the splits' merge in the same launch), the same route
  with the merge as a second launch (stage 1, then stage 2), and the
  classic route on the same bf16 inputs; each held to the plain version.
* K9 (the selective scan) at falcon-mamba-7b's prefill shape (1 x 32768 x
  8192, N 16, bf16, strided, with the final state): the kernel as built,
  and copies of its source with one design choice undone (``VARIANTS``),
  each built here with nvcc; each also run in float32 at (1, 2048, 8192,
  16) against the plain sequential scan, with ``chip_smoke.py``'s K9_TOL
  (1e-4 abs + rel on y and h) read as passed or broken.

A variant is its source with text substitutions; if the committed source no
longer holds a substitution's text, the script says which and exits
non-zero.  It prints one JSON line and exits non-zero without CUDA.
"""
import ctypes
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import mamba_scan as MS  # noqa: E402
from repro_torch.kernels import paged_decode as PD  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402

REPS = 20
K9_TOL = 1e-4
EX2 = ('__device__ __forceinline__ float ex2f_(float x) {\n  float y;\n'
       '  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));\n'
       '  return y;\n}\n\n')
VARIANTS = {
    # the exponential as ex2.approx of dt·a·log2(e), two instructions
    "ex2.approx exponential": [
        ("const float e = expf(dv * av[s]);",
         "const float e = ex2f_(dv * av[s] * 1.4426950408889634f);"),
        ("// TPC threads a channel, CH", EX2 + "// TPC threads a channel, CH")],
    # four blocks an SM (64 registers a thread), segments of 4 steps
    "4 blocks an SM, segments of 4 steps": [
        ("constexpr int kBlocksPerSM = 2;", "constexpr int kBlocksPerSM = 4;"),
        ("constexpr int kSegLen = 8;", "constexpr int kSegLen = 4;")],
    # two blocks an SM, segments of 4 steps
    "segments of 4 steps": [
        ("constexpr int kSegLen = 8;", "constexpr int kSegLen = 4;")],
}


def device_ms(fn, reps=REPS) -> float:
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def k8_inputs(batch, dev, seed):
    ps, kvh, hd, hq, n = 128, 8, 128, 48, 32769
    pps = -(-(n + 16) // ps)
    gen = torch.Generator(device=dev).manual_seed(seed)
    kp = torch.randn((batch * pps, ps, kvh, hd), generator=gen, device=dev,
                     dtype=torch.bfloat16)
    vp = torch.randn_like(kp)
    q = torch.randn((batch, hq, hd), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    table = torch.randperm(batch * pps, generator=gen, device=dev).reshape(
        batch, pps).to(torch.int32)
    lengths = [n] + [n // 2 + 997 * i for i in range(1, batch)]
    return q, kp, vp, table, torch.tensor(lengths, dtype=torch.int32,
                                          device=dev)


def k8(dev) -> dict:
    out = {}
    for batch in (1, 8):
        q, kp, vp, table, lengths = k8_inputs(batch, dev, batch)
        scale = 1 / math.sqrt(q.shape[-1])
        want = R.paged_decode_attention_ref(q, kp, vp, table, lengths).float()
        _, tparts = PD._launch(q, kp, vp, table, lengths, None, scale, 1,
                               path="tma")
        _, cparts = PD._launch(q, kp, vp, table, lengths, None, scale, 1,
                               path="classic")
        runs = {
            "tma, one launch": lambda: PD._launch(
                q, kp, vp, table, lengths, None, scale, 3, parts=tparts,
                path="tma")[0],
            "tma, merge as a second launch": lambda: PD._launch(
                q, kp, vp, table, lengths, None, scale, 2, parts=PD._launch(
                    q, kp, vp, table, lengths, None, scale, 1, parts=tparts,
                    path="tma")[1], path="tma")[0],
            "classic": lambda: PD._launch(
                q, kp, vp, table, lengths, None, scale, 3, parts=cparts,
                path="classic")[0]}
        for name, fn in runs.items():
            got = fn().float()
            rel = float(((got - want).norm(dim=-1) / want.norm(dim=-1)).max())
            if rel > 1e-2:
                raise SystemExit(f"K8 {name} at batch {batch}: rel {rel}")
            out[f"batch {batch}, {name}"] = {"ms": device_ms(fn),
                                             "rel_per_bh": rel}
            print(f"K8 nemotron decode batch {batch}, {name}: "
                  f"{out[f'batch {batch}, {name}']}", flush=True)
        del kp, vp
    return out


def variant_lib(name, subs) -> ctypes.CDLL:
    text = (_build.CSRC / "mamba_scan.cu").read_text()
    for old, new in subs:
        if old not in text:
            raise SystemExit(f"variant {name!r}: the source no longer holds "
                             f"{old!r}")
        text = text.replace(old, new)
    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    stem = out / ("mamba_scan_" + "".join(c if c.isalnum() else "_"
                                          for c in name))
    stem.with_suffix(".cu").write_text(text)
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                        str(stem.with_suffix(".so")),
                        str(stem.with_suffix(".cu"))],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"variant {name!r} failed to build:\n{r.stderr}")
    spills = [ln.strip() for ln in (r.stdout + r.stderr).splitlines()
              if "spill" in ln]
    lib = ctypes.CDLL(str(stem.with_suffix(".so")))
    base = MS._lib()
    for fn in ("roomy_mamba_scan", "roomy_ms_error_string"):
        getattr(lib, fn).argtypes = getattr(base, fn).argtypes
        getattr(lib, fn).restype = getattr(base, fn).restype
    lib.spills = max((int(s.split(" bytes spill stores")[0].split()[-1])
                      for s in spills), default=0)
    return lib


def k9_inputs(dev, shape, dtype, seed):
    b, l, di, n = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    xz = torch.randn((b, l, 2 * di), generator=gen, device=dev)
    xz[..., di:].abs_().mul_(0.1)
    xp = torch.randn((b, l, 256 + 2 * n), generator=gen, device=dev)
    x, dt = xz.to(dtype).split(di, -1)
    bb, cc = xp.to(dtype)[..., 256:].split(n, -1)
    a = -torch.rand((di, n), generator=gen, device=dev) * 16
    return x, dt, a, bb, cc, torch.randn((di,), generator=gen, device=dev)


def k9(dev) -> dict:
    libs = {"as built": MS._lib()}
    libs.update((name, variant_lib(name, subs))
                for name, subs in VARIANTS.items())
    big = k9_inputs(dev, (1, 32768, 8192, 16), torch.bfloat16, 7)
    small = k9_inputs(dev, (1, 2048, 8192, 16), torch.float32, 5)
    wy, wh = R.mamba_scan_seq_stateful(*small)
    out = {}
    for name in list(libs) + ["as built"]:
        MS._LIB = libs[name]
        gy, gh = MS.mamba_scan(*small, return_state=True)
        dy, dh = (gy - wy).abs(), (gh - wh).abs()
        ok = bool((dy <= K9_TOL + K9_TOL * wy.abs()).all()) and bool(
            (dh <= K9_TOL + K9_TOL * wh.abs()).all())
        ms = device_ms(lambda: MS.mamba_scan(*big, return_state=True))
        rec = {"ms": ms, "f32_max_abs_y": float(dy.max()),
               "f32_max_abs_h": float(dh.max()), "within_K9_TOL": ok,
               "spill_store_bytes_max": getattr(libs[name], "spills", None)}
        out.setdefault(name, []).append(rec)
        print(f"K9 falcon-mamba prefill shape, {name}: {rec}", flush=True)
    MS._LIB = libs["as built"]
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_variants: torch.cuda.is_available() is False")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _build.build(["paged_decode", "mamba_scan"])
    res = {"card": card, "k8": k8(dev), "k9": k9(dev)}
    print(json.dumps({"variants": res}))


if __name__ == "__main__":
    main()
