#!/usr/bin/env python3
"""Does torch.profiler keep the kernels of a short window?  On one NVIDIA
GPU, every 8 s for about two minutes, profile 5 back-to-back kernels
twice: in a bare window and in one padded by 50 ms of idle time on each
side.  Between windows the process launches bursts of small kernels, as
chip_smoke.py's plain versions do.  Prints per window the kernels traced
and, where all were, each kernel's traced start less its launch call's
(us; a kernel cannot start before it is launched, so this is the
timestamps' disagreement).

    python3 scripts/profiler_drift.py
"""
import json
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

if not torch.cuda.is_available():
    print("profiler_drift: CUDA is not available", file=sys.stderr)
    sys.exit(2)
dev = torch.device("cuda")
x = torch.randn(1 << 22, device=dev)
y = torch.randn(64, device=dev)
t_start = time.perf_counter()


def window(pad):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(pad)
        for _ in range(5):
            x.mul_(1.0)
        torch.cuda.synchronize()
        time.sleep(pad)
    ev = prof.events()
    kern = sorted(e.time_range.start for e in ev
                  if e.device_type == DeviceType.CUDA)
    launch = sorted(e.time_range.start for e in ev
                    if e.device_type == DeviceType.CPU
                    and e.name.startswith("cudaLaunchKernel"))
    skew = [k - c for k, c in zip(kern, launch)] if len(kern) == len(launch) \
        else None
    return len(kern), len(launch), skew


for it in range(14):
    n0, l0, _ = window(0.0)
    n1, l1, skew = window(0.05)
    print(json.dumps({"age_s": round(time.perf_counter() - t_start, 1),
                      "unpadded_seen": n0, "unpadded_launch_calls": l0,
                      "padded_seen": n1, "padded_launch_calls": l1,
                      "skew_us": skew}), flush=True)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 8:
        for _ in range(2000):
            y.add_(1.0)
        torch.cuda.synchronize()
