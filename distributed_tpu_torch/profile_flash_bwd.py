"""Where the time of the flash backward (kernel K3) goes, on the card.

Run from a checkout on a machine with one NVIDIA GPU:

    python3 distributed_tpu_torch/profile_flash_bwd.py [--root DIR] [--out FILE]

``--root`` names the checkout whose ``distributed_tpu_torch`` is
measured (default: the one holding this file), so one command can time
an unpacked ``git archive`` of another commit's K3 beside this one's, in
turns on one card.  For the bf16 cases of ``chip_smoke.py`` phase 2b (seq 8192, 16 heads,
head dim 128, causal and not, and 4096 queries against 8192 keys) and
its f32 cases (seq 1024, head dim 64), it reports:

- ``kernels``: from ``torch.profiler`` over one ``flash_backward_cuda``
  call, the device time and count of K3's three kernels (delta, dK/dV,
  dQ; ``other``: any kernel of the call none of those names matches, so
  the split sums to the call), and the sum of all kernels of one
  backward of ``scaled_dot_product_attention``, the library yardstick;
- ``k3_ms``: one ``flash_backward_cuda`` call (CUDA events, median of
  10), as ``chip_smoke.py`` phase 2b times it, and ``k2_ms``, one
  ``flash_forward_cuda`` call on the same inputs, as phase 2 times it;
- ``step_ms``: one training step of attention, forward then backward
  (CUDA events, median of 10), through ``flash_attention`` (K2 then K3,
  with its layout copies) and through ``scaled_dot_product_attention``
  on the same ``[seq, heads, dim]`` tensors.

Prints one JSON object, with the card's ``nvidia-smi`` name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

CASES = [
    # (label, seq, key seq, heads, head dim, dtype name, causal)
    ("bf16_causal", 8192, 8192, 16, 128, "bfloat16", True),
    ("bf16", 8192, 8192, 16, 128, "bfloat16", False),
    ("bf16_cross", 4096, 8192, 16, 128, "bfloat16", False),
    ("f32_causal", 1024, 1024, 16, 64, "float32", True),
    ("f32", 1024, 1024, 16, 64, "float32", False),
]
K3_KERNELS = ("bwd_delta", "bwd_dkdv", "bwd_dq")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    sys.path[0] = str(Path(args.root).resolve())

    import torch

    if not torch.cuda.is_available():
        print("profile_flash_bwd: no CUDA device", file=sys.stderr)
        return 2
    from distributed_tpu_torch.ops import flash
    from distributed_tpu_torch.profile_upload import cuda_ms
    from distributed_tpu_torch.profile_waves import kernel_times

    torch.backends.cuda.matmul.allow_tf32 = False
    sdpa = torch.nn.functional.scaled_dot_product_attention
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    report = {"root": args.root, "device": torch.cuda.get_device_name(0), "card": card,
              "cases": {}}
    for i, (label, n, nk, heads, dim, dtype_name, causal) in enumerate(CASES):
        dtype = getattr(torch, dtype_name)
        g = torch.Generator(device="cuda").manual_seed(100 + i)
        q, k, v, do = (torch.randn((s, heads, dim), generator=g, device="cuda").to(dtype)
                       for s in (n, nk, nk, n))
        scale = dim ** -0.5
        qt, kt, vt, dot = (x.transpose(0, 1).contiguous() for x in (q, k, v, do))
        o, lse = flash.flash_forward_cuda(qt, kt, vt, causal, scale)
        times = kernel_times(torch, lambda: flash.flash_backward_cuda(
            qt, kt, vt, o, lse, dot, causal, scale))
        kernels = {name: [sum(ms for key, (ms, _) in times.items() if name in key),
                          sum(c for key, (_, c) in times.items() if name in key)]
                   for name in K3_KERNELS}
        other = {key: v for key, v in times.items() if not any(n in key for n in K3_KERNELS)}
        kernels["other"] = [sum(ms for ms, _ in other.values()), sum(c for _, c in other.values())]
        k3_ms = cuda_ms(lambda: flash.flash_backward_cuda(qt, kt, vt, o, lse, dot, causal, scale),
                        reps=10)
        qs, ks, vs = (x[None].requires_grad_() for x in (qt, kt, vt))
        out = sdpa(qs, ks, vs, is_causal=causal, scale=scale)
        lib = kernel_times(torch, lambda: torch.autograd.grad(out, (qs, ks, vs), dot[None],
                                                               retain_graph=True))
        kernels["sdpa_backward_all"] = [sum(ms for ms, _ in lib.values()),
                                        sum(c for _, c in lib.values())]
        del out, qs, ks, vs

        leaves = [x.clone().requires_grad_() for x in (q, k, v)]

        def flash_step():
            flash.flash_attention(*leaves, causal=causal).backward(do)

        def sdpa_step():
            qh, kh, vh = (x.transpose(0, 1)[None] for x in leaves)
            sdpa(qh, kh, vh, is_causal=causal, scale=scale).backward(dot[None])

        k2_ms = cuda_ms(lambda: flash.flash_forward_cuda(qt, kt, vt, causal, scale), reps=10)
        row = {"kernels": kernels, "k3_ms": k3_ms, "k2_ms": k2_ms,
               "step_ms": {"flash_attention": cuda_ms(flash_step, reps=10),
                           "sdpa": cuda_ms(sdpa_step, reps=10)}}
        report["cases"][label] = row
        print(label, json.dumps(row), flush=True)
        del leaves, qt, kt, vt, dot, o, lse
        torch.cuda.empty_cache()
    text = json.dumps(report)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
