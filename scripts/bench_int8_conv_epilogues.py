#!/usr/bin/env python3
"""Device time of the port's int8 conv kernel per epilogue, on one GPU.

    python3 scripts/bench_int8_conv_epilogues.py

For the 1x1 stride-1 conv3 shapes of blocks 1-3 at 120 frames of 224x224
(56x56 64->256, 28x28 128->512, 14x14 256->1024), times one conv_s8 call
with each epilogue: int32, requant, dequant, dequant with a bf16 residual,
each of those with the next unit's pre-activation fused in (mode 1, the
XLA path's, with its division; mode 0, K2's), and K2's residual epilogue
with an f32 shortcut. Beside them, torch._int_mm on the same GEMM and a
copy of the residual, as yardsticks. Each time is the device time per call
over 10 calls queued behind a spin kernel (so the host's time per call does
not count). Prints the card's name and power limit first. Needs a CUDA
device; imports the port, never JAX.
"""

import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import torch  # noqa: E402

from human_dynamics_tpu_torch.ops import resnet_int8_cuda as K  # noqa: E402

SHAPES = ((120, 56, 64, 256), (120, 28, 128, 512), (120, 14, 256, 1024))
SPIN_CYCLES = 5_000_000  # longer than the host takes to queue 10 calls


def device_ms(fn, iters=10):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    for n, h, cin, cout in SHAPES:
        x = torch.randint(0, 128, (n, h, h, cin), generator=g, device=dev,
                          dtype=torch.int8)
        wt = torch.randint(-127, 128, (cout, cin), generator=g, device=dev,
                           dtype=torch.int8)
        mul = torch.rand(cout, generator=g, device=dev) * 1e-4
        add = torch.randn(cout, generator=g, device=dev)
        res = torch.randn(n, h, h, cout, generator=g, device=dev).to(
            torch.bfloat16)
        pa = torch.rand(cout, generator=g, device=dev).to(torch.bfloat16)
        pb = torch.randn(cout, generator=g, device=dev).to(torch.bfloat16)
        pq1 = K.Preact(pa.float(), pb.float(),
                       torch.tensor([0.05], device=dev), 1)
        pq0 = K.Preact(pa.float(), pb.float(), None, 0)
        deq = dict(epilogue="dequant", mul=mul, add=add)
        cases = {
            "int32": dict(epilogue="int32"),
            "requant": dict(epilogue="requant", mul=mul, add=add),
            "dequant": deq,
            "dequant+res": dict(deq, residual=res),
            "dequant+pq1": dict(deq, preact=pq1),
            "dequant+pq0": dict(deq, preact=pq0),
            "dequant+res+pq1": dict(deq, residual=res, preact=pq1),
            "dequant+res+pq0": dict(deq, residual=res, preact=pq0),
            "residual(f32)": dict(epilogue="residual", mul=mul, add=add,
                                  residual=res.float()),
        }
        a2 = x.reshape(-1, cin)
        print(f"{h}x{h} {cin}->{cout}: torch._int_mm "
              f"{device_ms(lambda: torch._int_mm(a2, wt.t())):.4f} ms; "
              f"copy of the residual {device_ms(res.clone):.4f} ms")
        for name, kw in cases.items():
            ms = device_ms(lambda: K.conv_s8(x, wt, 1, **kw))
            print(f"  {name:18s} {ms:.4f} ms")


if __name__ == "__main__":
    main()
