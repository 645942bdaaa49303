"""Whether a torch.distributed all_reduce holds the host until the GPU has
caught up, in a process group of one rank.

    python3 scripts/probe_collectives.py

On one GPU, first on NCCL, then on gloo (which copies a CUDA tensor
through the host): queue a spin kernel of about 20 ms, then call
``dist.all_reduce`` on a float32 tensor of N elements and time the call on
the host clock. A call that returns in microseconds left the spin running
behind it; one that takes about 20 ms waited for it. Then 53 calls in a
row, each after a small kernel, as a data-parallel ResNet-50 step makes
one per BatchNorm: the host time of the chain beside the device time of
the same kernels without the all_reduces. One line per case, and the
card's name and power limit (nvidia-smi) first. Needs a CUDA device.
"""

import os
import socket
import subprocess
import sys
import time


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main():
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        raise SystemExit("probe_collectives: no CUDA device")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(f"card: {card_line()}; torch {torch.__version__}")
    spin = 35_000_000  # cycles: ~20 ms at 1.755 GHz
    for backend in ("nccl", "gloo"):
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        dist.init_process_group(backend, init_method=f"tcp://localhost:"
                                f"{free_port()}", world_size=1, rank=0)
        try:
            for n in (4096, 100_000_000):
                t = torch.ones(n, device=dev)
                dist.all_reduce(t)
                torch.cuda.synchronize()
                torch.cuda._sleep(spin)
                t0 = time.perf_counter()
                dist.all_reduce(t)
                call = time.perf_counter() - t0
                torch.cuda.synchronize()
                total = time.perf_counter() - t0
                print(f"{backend}: all_reduce of {n} float32 behind a ~20 ms "
                      f"spin: the call returned after {call * 1e3:.3f} ms, "
                      f"the device finished after {total * 1e3:.3f} ms")
            x = torch.randn(160, 256, 28, 28, device=dev)
            small = torch.zeros(1, 2, 256, device=dev)

            def chain(reduce):
                for _ in range(53):
                    small.add_(x.mean(dim=(0, 2, 3)).reshape(1, 1, -1))
                    if reduce:
                        dist.all_reduce(small)

            for reduce in (False, True, False, True):
                chain(reduce)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                chain(reduce)
                host = time.perf_counter() - t0
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                print(f"{backend}: 53 x (a mean over a (160, 256, 28, 28) "
                      f"tensor{', then all_reduce of 512 float32' if reduce else ''}"
                      f"): host {host * 1e3:.3f} ms, wall to the device's end "
                      f"{wall * 1e3:.3f} ms")
        finally:
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
