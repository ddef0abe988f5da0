#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port ``distributed_tpu_torch``.

Run from the repository root on a machine with one NVIDIA GPU (built for
an H100, ``sm_90a``):

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result):

0. environment: torch/CUDA versions, the card, its power limit, nvcc,
   whether triton imports;
1. build: the four hand-written kernel sources from
   ``distributed_tpu_torch/ops/csrc`` (nvcc, one process a source) and the
   host pack ``distributed_tpu_torch/native/graphpack.cpp`` (g++), at once;
   K3's tensor-core kernels' registers and spills from ptxas (into the
   ``flash_bwd`` entry of the kernels line), failing if they spill or if
   ptxas serialised their wgmma (warning C7512);
2. flash attention forward (kernel K2) at seq 8192, 16 heads, head dim
   128 in bf16, causal and not (the tensor-core body), plus f32 at seq
   1024 / head dim 64 (the CUDA-core body), against the plain version on
   the card, with kernel / plain / library times;
2b. flash attention backward (kernel K3) through autograd:
   ``flash_attention(q, k, v).backward(dO)`` at the same widths plus a
   cross-length case (4096 queries against 8192 keys), K2 then K3 once
   each per case; on K2's residuals K3 within ``flash.BWD_TOL`` (+ the
   rounding terms) of the plain backward, bit-identical across two calls
   and to the autograd run, both planted faults (a q-tile left out of
   dK/dV, a k-tile out of dQ) rejected, and the whole autograd path within
   ``flash.E2E_RTOL`` of the plain forward and backward; K3's time beside
   the plain backward's, ``scaled_dot_product_attention``'s backward and
   the bound;
3. whole-graph placement (kernel K1): the 1M-task random DAG onto 512
   workers of 2 threads, a uniform fleet and a non-uniform one, through
   ``pack_graph`` and ``place_graph_leveled`` on the card (one launch for
   all waves of a graph), validated, equal bit for bit to the plain
   version on the CPU, and held against the same driver running the
   plain wave on the card;
4. streamed placement: the same graph and fleets through
   ``place_graph_streamed`` as the scheduler's plan path calls it (C++
   pack, chunked pinned uploads of the 11 B/task packed wire, a kernel
   launch per chunk that completes a wave, segmented download, C unpack)
   and the plan's hints; equal bit for bit to the same driver on the CPU,
   ``compact=False`` equal to phase 3's one-shot result, the packed wire
   within the reference's quality gate of the f16 wire; the C++ and numpy
   packs, and the placement wall of both wire formats beside the 250 ms
   north star;
5. the scheduler's placement extension: ``TorchPlacement(sync=True)``'s
   ``_plan_from_arrays``, the planner thread's whole job, on the
   rechunk + tensordot proxy (G = 24: 14,976 tasks) and a 16,384-task
   random DAG, which the router sends to the partitioner (kernel K4), and
   a 32,768-task random DAG, which it sends to the leveled engine (K1),
   on phase 3's two fleets (1,024 and 1,008 lanes); on ``fewlane``, 4
   workers of 4 threads (16 lanes), phase 3's 1M-task DAG and the proxy at
   G = 96 (903,168 tasks), which the router also sends to the
   partitioner; the hints equal the same call on the CPU, K4's labels
   equal its plain version's on the CPU bit for bit, and against the plain
   version on the card the plan costs the same within 1 %; K4's time
   beside its bound and ``chain_ms`` (the in-order add chain the contract
   forces), the plan's wall and hints time; then the 1M-task uniform
   batch through the extension, whose hints must equal phase 4's.

The last three lines are the card's ``nvidia-smi`` name and power limit,
one JSON object listing the kernels (``flash_fwd``, ``flash_bwd``,
``place_wave``, ``partition``) with their launches, errors and times, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# tolerances of the kernels against their plain versions on the card.
# K2's O: flash.O_TOL per element plus u * (P.|V|) / l where the
# tensor-core body rounds P (flash.o_excess states and derives it).
FLASH_TOL_LSE = 1e-3
FAULT_KEYS = 64              # the planted fault drops this many keys from P.V
# K1 sums per-worker loads in task order, as the plain version does on the
# CPU: the kernel must equal that run bit for bit.  The plain version on
# the card sums with CUDA's index_add_ (run in deterministic mode), in its
# own order, so against it a near-tie may flip a task:
K1_MIN_AGREEMENT = 0.999     # per wave, from identical state
K1_LOAD_RTOL = 1e-4          # load error on workers no flipped task touched
QUALITY_RTOL = 0.01          # imbalance and makespan, whole graph
QUALITY_CHOICE_PP = 0.01     # share of each choice, whole graph

# H100 SXM peaks (NVIDIA data sheet, dense)
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 67e12}

N_TASKS = 1_000_000
N_WORKERS = 512
THREADS = 2


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, reps=10, warmup=2):
    """Median milliseconds of ``fn`` over ``reps`` runs, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


# ------------------------------------------------------------ phases 0-1


def phase_env():
    from distributed_tpu_torch.ops import _build

    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    print(f"nvidia-smi {smi_line()}")
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    print("nvcc", [ln for ln in nvcc.splitlines() if "release" in ln][-1].strip())
    try:
        import triton
        print(f"triton {triton.__version__}")
    except ImportError:
        print("triton absent")


K3_TC_KERNELS = ("bwd_dkdv_tc_kernel", "bwd_dq_tc_kernel")


def ptxas_entries(log, names):
    """{label: {"registers": n, "spill_bytes": stores + loads}} for every
    entry function of the ptxas log whose name holds one of ``names``;
    the label is the name with its type, head dim and causal flag."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            mangled = m[1]
            name = next((n for n in names if n in mangled), None)
            cur = None
            if name is not None:
                dtype = "bf16" if "bfloat16" in mangled else "f16"
                dim = re.search(r"Li(\d+)E", mangled)[1]
                causal = "causal" if "Lb1E" in mangled else "full"
                cur = f"{name}<{dtype},{dim},{causal}>"
                out[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            out[cur]["spill_bytes"] = int(m[1]) + int(m[2])
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[cur]["registers"] = int(m[1])
    return out


def phase_build():
    """Builds everything; returns K3's tensor-core kernels' registers and
    spills from ptxas, and fails where ptxas serialised their wgmma
    (C7512) or they spill."""
    from distributed_tpu_torch import native
    from distributed_tpu_torch.ops import _build

    t0 = time.perf_counter()
    # g++ builds the host pack while nvcc builds the kernels
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        host = pool.submit(native.load)
        _build.load()
        host.result()
    print(f"build_s {time.perf_counter() - t0:.2f} ({_build.build_info['path']}, "
          f"{native.library_path()})")
    log = _build.build_info["log"]
    for ln in log.splitlines():
        if "registers" in ln or "spill" in ln or ln.startswith("==") or "C7512" in ln:
            print("  ptxas", ln.strip())
    if log == "(cached)":
        return {}
    bwd_log = log.split("== flash_bwd.cu", 1)[1].split("\n== ", 1)[0]
    check("C7512" not in bwd_log, "ptxas serialised wgmma in flash_bwd.cu (C7512)")
    k3 = ptxas_entries(bwd_log, K3_TC_KERNELS)
    check(len(k3) == 16, f"ptxas reported {len(k3)} K3 tensor-core kernels, not 16")
    for label, info in k3.items():
        print(f"  K3 {label}: {info.get('registers')} registers, "
              f"{info.get('spill_bytes')} spill bytes")
        check(info.get("spill_bytes") == 0, f"{label} spills: {info}")
    return k3


# ------------------------------------------------------------ phase 2


FLASH_CASES = [
    # (label, seq, heads, head dim, dtype, causal)
    ("bf16_causal", 8192, 16, 128, torch.bfloat16, True),
    ("bf16", 8192, 16, 128, torch.bfloat16, False),
    ("f32_causal", 1024, 16, 64, torch.float32, True),
    ("f32", 1024, 16, 64, torch.float32, False),
]
FLASH_HEADLINE = "bf16_causal"


def _flash_inputs(seq, heads, dim, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(
        torch.randn((seq, heads, dim), generator=g, device="cuda").to(dtype)
        for _ in range(3)
    )


def _flash_bound_ms(seq, heads, dim, dtype, causal):
    elem = torch.empty((), dtype=dtype).element_size()
    nbytes = 4 * heads * seq * dim * elem + 4 * heads * seq  # q k v o, lse
    pairs = seq * (seq + 1) // 2 if causal else seq * seq
    flops = 4 * heads * dim * pairs
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _drop_keys(qt, kt, vt, causal, scale, o_plain, lse_plain):
    """O of a planted fault: FAULT_KEYS keys in the middle of the sequence
    are left out of P.V but kept in l and lse, as by a kernel that skips
    one k-tile's product."""
    lo = kt.shape[1] // 2 // FAULT_KEYS * FAULT_KEYS
    hi = lo + FAULT_KEYS
    s = (qt.float() * scale) @ kt[:, lo:hi].float().transpose(1, 2)
    if causal:
        qpos = torch.arange(qt.shape[1], device=qt.device)[:, None]
        kpos = torch.arange(lo, hi, device=qt.device)[None, :]
        s = s.masked_fill(qpos < kpos, float("-inf"))
    p = torch.exp(s - lse_plain)
    return (o_plain.float() - p @ vt[:, lo:hi].float()).to(o_plain.dtype)


def phase_flash():
    from distributed_tpu_torch.ops import flash

    inputs = {c[0]: _flash_inputs(c[1], c[2], c[3], c[4], seed=i)
              for i, c in enumerate(FLASH_CASES)}
    # the main path: flash_attention as a user calls it, [seq, heads, dim]
    flash.flash_forward_cuda.launches = 0
    outs = {}
    for label, seq, heads, dim, dtype, causal in FLASH_CASES:
        q, k, v = inputs[label]
        outs[label] = flash.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    launches = flash.flash_forward_cuda.launches
    check(launches == len(FLASH_CASES), f"flash kernel launches {launches}")

    results = {}
    for label, seq, heads, dim, dtype, causal in FLASH_CASES:
        q, k, v = inputs[label]
        out = outs[label]
        check(out.shape == q.shape and out.dtype == dtype, f"{label}: output {out.shape} {out.dtype}")
        check(bool(torch.isfinite(out.float()).all()), f"{label}: non-finite output")
        qt, kt, vt = (x.transpose(0, 1).contiguous() for x in (q, k, v))
        scale = 1.0 / dim ** 0.5
        o_k, lse_k = flash.flash_forward_cuda(qt, kt, vt, causal, scale)
        o_p, lse_p = flash.flash_forward_reference(qt, kt, vt, causal, scale)
        u = flash.P_ROUNDOFF.get(dtype, 0.0)
        pv_term = u * flash.pv_rounding_term(qt, kt, vt, causal, scale, lse_p) if u else 0.0
        pv_max = float(pv_term.max().item()) if u else 0.0
        err_o = (o_k.float() - o_p.float()).abs().max().item()
        err_lse = (lse_k - lse_p).abs().max().item()
        excess = max(flash.o_excess(o_k, o_p, pv_term), flash.o_excess(out.transpose(0, 1), o_p, pv_term))
        # the check must reject a kernel that drops one k-tile's product
        fault = _drop_keys(qt, kt, vt, causal, scale, o_p, lse_p)
        fault_err = (fault.float() - o_p.float()).abs().max().item()
        fault_excess = flash.o_excess(fault, o_p, pv_term)
        del o_p, lse_p, fault, pv_term
        body = "tensor cores" if dtype in flash.P_ROUNDOFF else "cuda cores"
        check(excess <= 0.0, f"{label}: O off by {excess} beyond "
              f"(rtol, atol) {flash.O_TOL[dtype]} + u (P|V|)/l (max {pv_max}), max abs err {err_o}")
        check(fault_excess > 0.0, f"{label}: the O check passes a planted fault "
              f"(max abs err {fault_err})")
        check(err_lse <= FLASH_TOL_LSE, f"{label}: lse max abs err {err_lse} > {FLASH_TOL_LSE}")
        ms = cuda_ms(lambda: flash.flash_forward_cuda(qt, kt, vt, causal, scale))
        plain_ms = cuda_ms(lambda: flash.flash_forward_reference(qt, kt, vt, causal, scale))
        qs, ks, vs = qt[None], kt[None], vt[None]
        lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, is_causal=causal, scale=scale))
        bound_ms, bound_by = _flash_bound_ms(seq, heads, dim, dtype, causal)
        results[label] = dict(body=body, max_abs_err=err_o, lse_err=err_lse,
                              o_excess=excess, pv_term_max=pv_max,
                              fault_max_abs_err=fault_err, fault_excess=fault_excess,
                              ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                              bound_ms=bound_ms, bound_by=bound_by)
        print(f"flash {label} seq {seq} heads {heads} dim {dim} ({body}): err_o {err_o:.3g} "
              f"u(P|V|)/l max {pv_max:.3g} "
              f"(excess {excess:.3g}; planted fault err {fault_err:.3g} excess "
              f"{fault_excess:.3g}) err_lse {err_lse:.3g} kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
              f"library_ms {lib_ms:.4f} bound_ms {bound_ms:.4f} ({bound_by})")
        torch.cuda.empty_cache()
    head = results[FLASH_HEADLINE]
    return {
        "name": "flash_fwd",
        "route": "cuda",
        "source": "distributed_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "distributed_tpu/ops/flash.py:35",
        "launches": launches,
        "max_abs_err": head["max_abs_err"],
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "case": FLASH_HEADLINE,
        "cases": results,
    }


# ------------------------------------------------------------ phase 2b


BWD_CASES = [
    # (label, seq, key seq, heads, head dim, dtype, causal)
    ("bf16_causal", 8192, 8192, 16, 128, torch.bfloat16, True),
    ("bf16", 8192, 8192, 16, 128, torch.bfloat16, False),
    ("bf16_cross", 4096, 8192, 16, 128, torch.bfloat16, False),
    ("f32_causal", 1024, 1024, 16, 64, torch.float32, True),
    ("f32", 1024, 1024, 16, 64, torch.float32, False),
]


def _bwd_bound_ms(n, nk, heads, dim, dtype, causal):
    """Five products of 2*D operations per (query, key) pair that the mask
    keeps (no causal offset: query i sees keys 0..i); each of q, k, v, o,
    dO, lse read once and dq, dk, dv written once."""
    elem = torch.empty((), dtype=dtype).element_size()
    nbytes = 4 * heads * (n + nk) * dim * elem + 4 * heads * n
    pairs = sum(min(i + 1, nk) for i in range(n)) if causal else n * nk
    flops = 10 * heads * dim * pairs
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_flash_bwd(fwd_entry, k3_ptxas):
    """Phase 2b: ``flash_attention(...)`` on tensors that require grad,
    then ``backward()``, as a user trains through it: K2 then K3.
    ``k3_ptxas``: phase 1's registers and spills of K3's kernels."""
    from distributed_tpu_torch.ops import flash

    card = smi_line()
    inputs = {}
    for i, (label, n, nk, heads, dim, dtype, causal) in enumerate(BWD_CASES):
        g = torch.Generator(device="cuda").manual_seed(100 + i)
        inputs[label] = tuple(
            torch.randn((s, heads, dim), generator=g, device="cuda").to(dtype)
            for s in (n, nk, nk, n))  # q k v dO

    # the main path: forward and backward through autograd, [seq, heads, dim]
    flash.flash_forward_cuda.launches = 0
    flash.flash_backward_cuda.launches = 0
    grads = {}
    for label, n, nk, heads, dim, dtype, causal in BWD_CASES:
        q, k, v, do = (x.clone().requires_grad_(j < 3) for j, x in enumerate(inputs[label]))
        flash.flash_attention(q, k, v, causal=causal).backward(do)
        grads[label] = (q.grad, k.grad, v.grad)
    torch.cuda.synchronize()
    k2, k3 = flash.flash_forward_cuda.launches, flash.flash_backward_cuda.launches
    check(k3 == len(BWD_CASES), f"flash backward launches {k3} != {len(BWD_CASES)} backwards")
    check(k2 == len(BWD_CASES), f"flash forward launches {k2} in the autograd path")
    fwd_entry["launches"] += k2
    fwd_entry["launches_autograd"] = k2
    print(f"[{card}] flash autograd main path: K2 launches {k2}, K3 launches {k3} "
          f"(one each per backward)")

    results, err_max = {}, 0.0
    for label, n, nk, heads, dim, dtype, causal in BWD_CASES:
        q, k, v, do = inputs[label]
        for x, gr in zip((q, k, v), grads[label]):
            check(gr.shape == x.shape and gr.dtype == dtype, f"{label}: grad {gr.shape} {gr.dtype}")
            check(bool(torch.isfinite(gr.float()).all()), f"{label}: non-finite gradient")
        qt, kt, vt, dot = (x.transpose(0, 1).contiguous() for x in (q, k, v, do))
        scale = 1.0 / dim ** 0.5
        # identical residuals: K2's O and lse, as the Function saves them
        o, lse = flash.flash_forward_cuda(qt, kt, vt, causal, scale)
        res = (qt, kt, vt, o, lse, dot)
        got = flash.flash_backward_cuda(*res, causal, scale)
        again = flash.flash_backward_cuda(*res, causal, scale)
        check(all(torch.equal(a, b) for a, b in zip(got, again)), f"{label}: two K3 calls differ")
        check(all(torch.equal(a, b.transpose(0, 1)) for a, b in zip(got, grads[label])),
              f"{label}: the autograd path's gradients are not K3's on its residuals")
        plain = flash.flash_backward_reference(*res, causal, scale)
        u = flash.P_ROUNDOFF.get(dtype, 0.0)
        terms = flash.bwd_rounding_terms(*res, causal, scale) if u else None
        excess = flash.bwd_excess(got, plain, terms)
        errs = [(a.float() - b.float()).abs().max().item() for a, b in zip(got, plain)]
        fault_a, fault_b = flash.bwd_planted_faults(*res, causal, scale, plain)
        fault_excess = (flash.bwd_excess(fault_a, plain, terms)[1:],
                        flash.bwd_excess(fault_b, plain, terms)[0])
        # end to end: K2 + K3 against the plain forward + backward on the card
        o_p, lse_p = flash.flash_forward_reference(qt, kt, vt, causal, scale)
        e2e_plain = flash.flash_backward_reference(qt, kt, vt, o_p, lse_p, dot, causal, scale)
        e2e = [(a.transpose(0, 1).float() - b.float()).abs().max().item()
               / max(b.float().abs().max().item(), 1e-30)
               for a, b in zip(grads[label], e2e_plain)]
        del fault_a, fault_b, e2e_plain, o_p, lse_p, terms
        rtol, atol = flash.BWD_TOL[dtype]
        check(max(excess) <= 0.0, f"{label}: (dQ, dK, dV) beyond (rtol, atol) ({rtol}, {atol}) "
              f"+ u terms by {excess}, max abs err {errs}")
        check(max(fault_excess[0]) > 0.0, f"{label}: the check passes a q-tile left out of "
              f"dK/dV (excess {fault_excess[0]})")
        check(fault_excess[1] > 0.0, f"{label}: the check passes a k-tile left out of dQ "
              f"(excess {fault_excess[1]})")
        check(max(e2e) <= flash.E2E_RTOL[dtype], f"{label}: end to end off by {e2e} of max "
              f"|grad| > {flash.E2E_RTOL[dtype]}")

        ms = cuda_ms(lambda: flash.flash_backward_cuda(*res, causal, scale))
        plain_ms = cuda_ms(lambda: flash.flash_backward_reference(*res, causal, scale))
        qs, ks, vs = (x[None].requires_grad_() for x in (qt, kt, vt))
        out = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, is_causal=causal,
                                                               scale=scale)
        lib_ms = cuda_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), dot[None],
                                                     retain_graph=True))
        del out, qs, ks, vs
        bound_ms, bound_by = _bwd_bound_ms(n, nk, heads, dim, dtype, causal)
        body = "tensor cores" if u else "cuda cores"
        err_max = max(err_max, *errs)
        results[label] = dict(body=body, max_abs_err=max(errs), max_abs_err_dq_dk_dv=errs,
                              excess_dq_dk_dv=list(excess),
                              fault_excess_dk_dv=list(fault_excess[0]),
                              fault_excess_dq=fault_excess[1], e2e_rel_err_dq_dk_dv=e2e,
                              ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                              bound_ms=bound_ms, bound_by=bound_by)
        print(f"[{card}] flash_bwd {label} seq {n}x{nk} heads {heads} dim {dim} ({body}): "
              f"max abs err dq/dk/dv {[f'{e:.3g}' for e in errs]} excess "
              f"{[f'{e:.3g}' for e in excess]} (planted faults: dk/dv "
              f"{[f'{e:.3g}' for e in fault_excess[0]]}, dq {fault_excess[1]:.3g}); end to end "
              f"{[f'{e:.3g}' for e in e2e]} of max |grad|; kernel_ms {ms:.4f} plain_ms "
              f"{plain_ms:.4f} library_ms {lib_ms:.4f} bound_ms {bound_ms:.4f} ({bound_by})")
        del res, got, again, plain, o, lse
        torch.cuda.empty_cache()
    head = results[FLASH_HEADLINE]
    return {
        "name": "flash_bwd",
        "route": "cuda",
        "source": "distributed_tpu_torch/ops/csrc/flash_bwd.cu",
        "replaces": "distributed_tpu/ops/flash.py:156",
        "launches": k3,
        "max_abs_err": err_max,
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "case": FLASH_HEADLINE,
        "cases": results,
        "ptxas": k3_ptxas,
    }


# ------------------------------------------------------------ phase 3


def _fleets():
    uniform = (np.full(N_WORKERS, THREADS, np.int32),
               np.zeros(N_WORKERS, np.float32), np.ones(N_WORKERS, bool))
    running = np.ones(N_WORKERS, bool)
    running[:8] = False
    mixed = (np.full(N_WORKERS, THREADS, np.int32),
             np.random.default_rng(1).uniform(0, 5, N_WORKERS).astype(np.float32),
             running)
    return {"uniform": uniform, "nonuniform": mixed}


@contextlib.contextmanager
def deterministic():
    """Deterministic torch kernels (index_add_ without atomics) inside."""
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def _quality(run, res, running):
    occ = res.occupancy[running]
    share = np.bincount(res.choice, minlength=3) / len(res.choice)
    return dict(imbalance=float(occ.max() / occ.mean()),
                makespan=float(run.spans.sum().item()), share=share)


def _same(a, b):
    return all(np.array_equal(getattr(a, f), getattr(b, f))
               for f in ("assignment", "choice", "occupancy", "start_time"))


def _lockstep(run, leveled):
    """From the plain version's state before each wave, run the kernel
    on a copy of it and compare: (min agreement, max load error on
    workers untouched by a disagreeing task, disagreeing tasks)."""
    run.reset()
    min_agree, max_err, flips = 1.0, 0.0, 0
    for wave in range(run.packed.n_levels):
        off, f = run.wave_bounds(wave)
        saved = (run.assign.clone(), run.choices.clone(), run.load.clone(), run.spans.clone())
        leveled.place_wave_cuda(run, wave)
        a_k, load_k = run.assign[off:off + f].clone(), run.load.clone()
        for dst, src in zip((run.assign, run.choices, run.load, run.spans), saved):
            dst.copy_(src)
        leveled.place_wave_reference(run, wave)
        a_p = run.assign[off:off + f]
        differ = a_k != a_p
        n_diff = int(differ.sum().item())
        touched = torch.zeros(run.fleet.W, dtype=torch.bool, device=run.device)
        touched[a_k[differ].long()] = True
        touched[a_p[differ].long()] = True
        ok = ~touched
        err = (load_k - run.load)[ok].abs().max().item() if bool(ok.any()) else 0.0
        rel = err / max(run.load.abs().max().item(), 1e-30)
        check(rel <= K1_LOAD_RTOL, f"wave {wave}: load error {err} (rel {rel}) > {K1_LOAD_RTOL}")
        agree = 1.0 - n_diff / f
        check(agree >= K1_MIN_AGREEMENT, f"wave {wave}: agreement {agree} < {K1_MIN_AGREEMENT}")
        min_agree, max_err, flips = min(min_agree, agree), max(max_err, err), flips + n_diff
    return min_agree, max_err, flips


def _k1_bound_ms(packed, W, wire_bytes=16):
    """Least time for the whole graph's waves: each input read once (the
    wire, 16 B/task f16 or 11 B/task packed, the fleet tables), each
    output written once (i32 assign and choice per task, the load, the
    spans); about 40 f32 operations a task (two rounds of three costs,
    two argmins, two sums) plus a W log W sort of the workers per wave."""
    T, L = packed.n, packed.n_levels
    nbytes = wire_bytes * T + 8 * T + 13 * W + 4 * W + 4 * L
    flops = 40 * T + L * W * max(W.bit_length() - 1, 1)
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[torch.float32] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_placement():
    from distributed_tpu_torch import graphs
    from distributed_tpu_torch.ops import leveled

    durations, out_bytes, src, dst = graphs.random_dag(N_TASKS, seed=0)
    fleets = _fleets()

    # the main path: pack_graph + place_graph_leveled as a user calls them
    leveled.place_waves_cuda.launches = 0
    packs, results, pack_ms = {}, {}, {}
    for name, fleet in fleets.items():
        t0 = time.perf_counter()
        packs[name] = leveled.pack_graph(durations, out_bytes, src, dst)
        pack_ms[name] = (time.perf_counter() - t0) * 1e3
        results[name] = leveled.place_graph_leveled(packs[name], *fleet)
    launches = leveled.place_waves_cuda.launches
    n_waves = sum(p.n_levels for p in packs.values())
    check(launches == len(fleets), f"wave kernel launches {launches} != graph runs {len(fleets)}")
    print(f"placement main path: wave kernel launches {launches} (one per graph run) "
          f"over {n_waves} waves")

    entry = None
    for name, fleet in fleets.items():
        packed, res, running = packs[name], results[name], fleet[2]
        leveled.validate_leveled(packed, res, src, dst, running)
        check(np.isfinite(res.start_time).all() and np.isfinite(res.occupancy).all(),
              f"{name}: non-finite result")

        # the kernel against the plain version on the CPU: bit for bit
        t0 = time.perf_counter()
        res_cpu = leveled.place_graph_leveled(packed, *fleet, device="cpu")
        cpu_s = time.perf_counter() - t0
        err = max(float(np.abs(res.occupancy - res_cpu.occupancy).max()),
                  float(np.abs(res.start_time - res_cpu.start_time).max()))
        same = _same(res, res_cpu)
        print(f"placement {name}: kernel vs plain on the CPU ({cpu_s:.1f} s): "
              f"identical {same}, assignment agreement "
              f"{float((res.assignment == res_cpu.assignment).mean()):.6f}, max abs err {err:.3g}")
        check(same, f"{name}: kernel differs from the plain version on the CPU")

        # against the plain version on the card: the quality gate
        run = leveled.LeveledRun(packed, *fleet)
        with deterministic():
            run.run_waves(leveled.place_wave_reference)
        res_p = run.download()
        leveled.validate_leveled(packed, res_p, src, dst, running)
        q_p = _quality(run, res_p, running)
        run.reset()
        run.run_waves()
        res_k = run.download()
        check(_same(res_k, res), f"{name}: two kernel runs differ")
        run.reset()
        run.run_waves(leveled.place_wave_cuda)
        check(_same(run.download(), res), f"{name}: per-wave launches differ from one launch")
        q_k = _quality(run, res_k, running)
        agreement = float((res_k.assignment == res_p.assignment).mean())
        d_imb = abs(q_k["imbalance"] - q_p["imbalance"]) / q_p["imbalance"]
        d_mk = abs(q_k["makespan"] - q_p["makespan"]) / q_p["makespan"]
        d_share = float(np.abs(q_k["share"] - q_p["share"]).max())
        print(f"placement {name}: waves {packed.n_levels} imbalance {q_k['imbalance']:.6f} "
              f"(plain {q_p['imbalance']:.6f}) makespan {q_k['makespan']:.4f} "
              f"(plain {q_p['makespan']:.4f}) choice share {q_k['share'].round(5).tolist()} "
              f"(plain {q_p['share'].round(5).tolist()}) raw agreement {agreement:.6f}")
        check(bool(running[res_k.assignment].all()), f"{name}: task on a stopped worker")
        check(d_imb <= QUALITY_RTOL, f"{name}: imbalance off by {d_imb}")
        check(d_mk <= QUALITY_RTOL, f"{name}: makespan off by {d_mk}")
        check(d_share <= QUALITY_CHOICE_PP, f"{name}: choice share off by {d_share}")

        with deterministic():
            min_agree, load_err, flips = _lockstep(run, leveled)
        print(f"placement {name}: per-wave lockstep with the plain version on the card: "
              f"min agreement {min_agree:.6f} flipped tasks {flips} max load err {load_err:.3g}")

        def whole_graph():
            r = leveled.LeveledRun(packed, *fleet)
            r.run_waves()
            r.codes().cpu(), r.spans.cpu(), r.load.cpu()

        device_ms = cuda_ms(whole_graph, reps=3, warmup=1)
        # where device_ms goes: host staging + upload, waves, download
        upload_ms = cuda_ms(lambda: leveled.LeveledRun(packed, *fleet), reps=3, warmup=1)
        download_ms = cuda_ms(lambda: run.codes().cpu(), reps=3, warmup=1)
        codes = run.codes().cpu().numpy().astype(np.int32)
        spans_h, load_h = run.spans.cpu().numpy(), run.load.cpu().numpy()
        t0 = time.perf_counter()
        leveled._finalize(packed, codes, spans_h, load_h)
        finalize_ms = (time.perf_counter() - t0) * 1e3

        def waves(fn=None):
            run.reset()
            run.run_waves(fn)

        ms = cuda_ms(waves)
        plain_ms = cuda_ms(lambda: waves(leveled.place_wave_reference))
        bound_ms, bound_by = _k1_bound_ms(packed, N_WORKERS)
        print(f"placement {name}: pack_ms {pack_ms[name]:.1f} device_ms {device_ms:.3f} "
              f"(upload_ms {upload_ms:.3f} download_ms {download_ms:.3f}) "
              f"finalize_ms {finalize_ms:.1f} waves {packed.n_levels} kernel_ms {ms:.4f} "
              f"plain_ms {plain_ms:.4f} bound_ms {bound_ms:.4f} ({bound_by})")
        case = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by, device_ms=device_ms, upload_ms=upload_ms,
                    download_ms=download_ms, finalize_ms=finalize_ms,
                    pack_ms=pack_ms[name], card_plain_agreement=agreement,
                    card_plain_min_wave_agreement=min_agree,
                    card_plain_load_err=load_err)
        if entry is None:
            entry = {
                "name": "place_wave",
                "route": "cuda",
                "source": "distributed_tpu_torch/ops/csrc/place_wave.cu",
                "replaces": "distributed_tpu/ops/leveled.py:326",
                "launches": launches,
                "max_abs_err": err,
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "library_ms": None,
                "case": name,
                "cases": {},
            }
        entry["cases"][name] = case
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
    return entry, results


# ------------------------------------------------------------ phase 4


NORTH_STAR_MS = 250.0        # the placement wall at 1M tasks / 512 workers
BANDWIDTH, LATENCY = 100e6, 0.001  # pack_graph's defaults, as phase 3 packs
STREAM_REPS = 3
# the reference's gate for its packed wire against the f16 wire
# (tests/test_leveled_streamed.py:116-122)
PACKED_RTOL, PACKED_ATOL, PACKED_MIN_AGREEMENT = 1.15, 0.05, 0.5


def _streamed_launches(offsets, chunk_rows, T):
    """Launches of the streamed driver: the chunks after which at least
    one more wave's last row has landed."""
    C = min(chunk_rows, T)
    return len(set(((offsets[1:].astype(np.int64) + C - 1) // C).tolist()))


def _result_quality(res, running):
    occ = res.occupancy[running]
    return dict(imbalance=float(occ.max() / occ.mean()), makespan=float(res.spans.sum()),
                share=np.bincount(res.choice, minlength=3) / len(res.choice))


def _median(runs, key):
    return statistics.median(r[key] for r in runs)


def phase_streamed(entry, oneshot):
    """Phase 4: the scheduler's placement path, ``place_graph_streamed`` as
    the leveled branch of ``_plan_from_arrays`` calls it (the packed wire
    on the card), then the plan's hints (``scheduler/plan.py``)."""
    import inspect

    from distributed_tpu_torch import graphs
    from distributed_tpu_torch.ops import leveled
    from distributed_tpu_torch.scheduler import plan

    card = smi_line()
    graph = graphs.random_dag(N_TASKS, seed=0)
    src, dst = graph[2], graph[3]
    fleets = _fleets()
    keys = [f"task-{i}" for i in range(N_TASKS)]
    addrs = [f"tcp://10.1.{w // 256}.{w % 256}:8788" for w in range(N_WORKERS)]
    chunk_rows = inspect.signature(leveled.place_graph_streamed).parameters["chunk_rows"].default

    # the main path, as the scheduler plans a batch
    leveled.place_waves_cuda.launches = 0
    main, hints, hints_ms = {}, {}, {}
    for name, fleet in fleets.items():
        tm = {}
        packed, res = leveled.place_graph_streamed(
            *graph, *fleet, bandwidth=BANDWIDTH, latency=LATENCY, timings=tm)
        t0 = time.perf_counter()
        hints[name] = plan.hints_from_placement(keys, packed, res, addrs)
        hints_ms[name] = (time.perf_counter() - t0) * 1e3
        main[name] = (packed, res, tm)
    torch.cuda.synchronize()
    launches = leveled.place_waves_cuda.launches
    want = sum(_streamed_launches(p.offsets, chunk_rows, N_TASKS) for p, _, _ in main.values())
    check(launches == want, f"streamed wave launches {launches} != chunks completing a wave {want}")
    print(f"[{card}] streamed main path: wave kernel launches {launches} (one per chunk "
          f"that completed a wave, chunks of {chunk_rows} rows)")

    report = {}
    for name, fleet in fleets.items():
        packed, res, tm = main[name]
        running = fleet[2]
        check(tm["fmt"] == "packed", f"{name}: streamed fmt {tm['fmt']} on the card")
        check("fallback" not in tm, f"{name}: the streamed driver fell back")
        check(tm["launches"] == _streamed_launches(packed.offsets, chunk_rows, N_TASKS),
              f"{name}: {tm['launches']} launches")
        leveled.validate_leveled(packed, res, src, dst, running)
        check(np.isfinite(res.start_time).all() and np.isfinite(res.occupancy).all(),
              f"{name}: non-finite result")
        h = hints[name]
        check(len(h) == N_TASKS and set(a for _, a in h.values()) <= set(addrs),
              f"{name}: {len(h)} hints")
        check(sum(f is not None for f, _ in h.values()) == int((res.choice < 2).sum()),
              f"{name}: follow hints differ from the locality choices")

        # the packed run on the card against the same driver on the CPU
        t0 = time.perf_counter()
        _, res_cpu = leveled.place_graph_streamed(
            *graph, *fleet, bandwidth=BANDWIDTH, latency=LATENCY, compact=True, device="cpu")
        cpu_s = time.perf_counter() - t0
        err = max(float(np.abs(res.occupancy - res_cpu.occupancy).max()),
                  float(np.abs(res.start_time - res_cpu.start_time).max()))
        check(_same(res, res_cpu), f"{name}: packed streamed run differs from the CPU run")
        # compact=False on the card against phase 3's one-shot result
        _, exact = leveled.place_graph_streamed(
            *graph, *fleet, bandwidth=BANDWIDTH, latency=LATENCY, compact=False)
        check(_same(exact, oneshot[name]), f"{name}: compact=False differs from the one-shot driver")
        q_p, q_e = _result_quality(res, running), _result_quality(exact, running)
        d_imb = abs(q_p["imbalance"] - q_e["imbalance"]) / q_e["imbalance"]
        d_mk = abs(q_p["makespan"] - q_e["makespan"]) / q_e["makespan"]
        d_share = float(np.abs(q_p["share"] - q_e["share"]).max())
        agreement = float((res.assignment == exact.assignment).mean())
        print(f"[{card}] streamed {name}: packed == CPU plain run ({cpu_s:.1f} s); "
              f"compact=False == one-shot; packed vs f16 wire: imbalance "
              f"{q_p['imbalance']:.6f} / {q_e['imbalance']:.6f}, makespan {q_p['makespan']:.4f} / "
              f"{q_e['makespan']:.4f}, share {q_p['share'].round(5).tolist()} / "
              f"{q_e['share'].round(5).tolist()}, agreement {agreement:.6f}")
        # the packed wire's quantized costs change the plan: held to the
        # reference's own gate for that wire (imbalance, and here makespan,
        # within 15 % + 0.05, over half the assignments equal) and phase
        # 3's choice-share gate.  Phase 3's 1 % on imbalance and makespan
        # does not hold on the non-uniform fleet, for the reference's
        # packed wire either (PERF.md, port slice 3).
        print(f"[{card}] streamed {name}: packed vs f16 wire: imbalance off by {d_imb:.5f}, "
              f"makespan by {d_mk:.5f}, choice share by {d_share:.5f}")
        check(q_p["imbalance"] < q_e["imbalance"] * PACKED_RTOL + PACKED_ATOL,
              f"{name}: packed imbalance {q_p['imbalance']} against {q_e['imbalance']}")
        check(q_p["makespan"] < q_e["makespan"] * PACKED_RTOL + PACKED_ATOL,
              f"{name}: packed makespan {q_p['makespan']} against {q_e['makespan']}")
        check(agreement > PACKED_MIN_AGREEMENT, f"{name}: packed agreement {agreement}")
        check(d_share <= QUALITY_CHOICE_PP, f"{name}: packed choice share off by {d_share}")

        # the host pack: C++ against numpy, in this call
        cpp_ms = []
        for _ in range(STREAM_REPS):
            t0 = time.perf_counter()
            leveled.pack_graph(*graph, bandwidth=BANDWIDTH, latency=LATENCY)
            cpp_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        leveled.pack_graph_numpy(*graph, bandwidth=BANDWIDTH, latency=LATENCY)
        numpy_ms = (time.perf_counter() - t0) * 1e3

        # the placement wall of both wire formats, after the main path's run
        walls = {}
        for fmt, compact in (("packed", "auto"), ("f16", False)):
            runs = []
            for _ in range(STREAM_REPS):
                tm_r = {}
                leveled.place_graph_streamed(*graph, *fleet, bandwidth=BANDWIDTH,
                                             latency=LATENCY, compact=compact, timings=tm_r)
                check(tm_r["fmt"] == fmt, f"{name}: fmt {tm_r['fmt']} != {fmt}")
                runs.append(tm_r)
            walls[fmt] = w = {k: _median(runs, k) for k in (
                "total_s", "topo_s", "fill_wait_s", "encode_s", "upload_ms", "waves_ms",
                "wait_s", "finalize_s")}
            walls[fmt]["total_s_runs"] = [r["total_s"] for r in runs]
            print(f"[{card}] streamed {name} fmt {fmt} (median of {STREAM_REPS}): "
                  f"total_ms {w['total_s'] * 1e3:.2f} topo_ms {w['topo_s'] * 1e3:.2f} "
                  f"fill_wait_ms {w['fill_wait_s'] * 1e3:.2f} encode_ms {w['encode_s'] * 1e3:.2f} "
                  f"upload_ms {w['upload_ms']:.3f} waves_ms {w['waves_ms']:.3f} "
                  f"final_segment_wait_ms {w['wait_s'] * 1e3:.3f} "
                  f"finalize_ms {w['finalize_s'] * 1e3:.2f}: a wall of {w['total_s'] * 1e3:.2f} ms "
                  f"against the {NORTH_STAR_MS:.0f} ms north star")
        print(f"[{card}] streamed {name}: pack_ms C++ {statistics.median(cpp_ms):.2f} "
              f"(runs {[round(x, 2) for x in cpp_ms]}) numpy {numpy_ms:.1f}; main-path run "
              f"total_ms {tm['total_s'] * 1e3:.2f}; hints_ms {hints_ms[name]:.1f}")

        # K1 on the packed wire: the kernel against its plain version
        run = leveled.LeveledRun(packed, *fleet, fmt="packed")

        def waves(fn=None):
            run.reset()
            run.run_waves(fn)

        ms = cuda_ms(waves)
        plain_ms = cuda_ms(lambda: waves(leveled.place_wave_reference), reps=3, warmup=1)
        bound_ms, bound_by = _k1_bound_ms(packed, N_WORKERS, wire_bytes=11)
        print(f"[{card}] place_wave {name}_packed: launches {tm['launches']} max_abs_err {err:.3g} "
              f"kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} bound_ms {bound_ms:.4f} ({bound_by})")
        entry["cases"][f"{name}_packed"] = dict(
            launches=tm["launches"], max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by)
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        report[name] = dict(pack_ms_cpp=statistics.median(cpp_ms), pack_ms_numpy=numpy_ms,
                            main_total_ms=tm["total_s"] * 1e3, hints_ms=hints_ms[name],
                            walls=walls, agreement_packed_f16=agreement, cpu_s=cpu_s)
        del run
        torch.cuda.empty_cache()
    entry["launches"] += launches
    entry["launches_streamed"] = launches
    print(json.dumps({"streamed": report, "card": card}))
    return hints["uniform"]


# ------------------------------------------------------------ phase 5


PART_TASKS = 16_384          # the largest graph the router sends to K4 on 1024 lanes
LEVELED_TASKS = 32_768       # bucket 32768 x 1008 or 1024 lanes > DENSE_LIMIT
# one machine's LocalCluster on 16 cores, 4 workers x 4 threads: 16 lanes,
# where the router sends the partitioner up to 1,048,576 tasks
FEW_WORKERS, FEW_THREADS = 4, 4
# the partitioner's plans: (graph, fleet), blockwise96 the proxy at full
# size (903,168 tasks, 2,654,208 edges); phase 5 adds random32768 on the
# 512-worker fleets, which the router sends to the leveled engine
PART_PLANS = [("blockwise24", "uniform"), ("blockwise24", "nonuniform"),
              ("random16384", "uniform"), ("random16384", "nonuniform"),
              ("random1m", "fewlane"), ("blockwise96", "fewlane")]
# K4 adds every score cell and lane load in the reference's order: it must
# equal the plain version on the CPU bit for bit.  The plain version on the
# card sums with CUDA's index_add_ (deterministic mode), in its own order,
# so against it near-ties may move tasks; the plan must then cost about the
# same: comm volume and the heaviest lane's load within 1 %.
K4_RTOL = 0.01
K4_LAUNCHES_PER_PLAN = 1         # all rounds in one cooperative launch
FADD_CYCLES = 4                  # latency of a dependent f32 add on an SM


def partition_fleets():
    """Phase 3's two fleets (1,024 and 1,008 lanes) and ``fewlane`` (16
    lanes, all running, idle), each with its workers' addresses."""
    fleets = _fleets()
    fleets["fewlane"] = (np.full(FEW_WORKERS, FEW_THREADS, np.int32),
                         np.zeros(FEW_WORKERS, np.float32), np.ones(FEW_WORKERS, bool))
    addrs = [f"tcp://10.1.{w // 256}.{w % 256}:8788" for w in range(N_WORKERS)]
    few = [f"tcp://10.2.0.{w}:8788" for w in range(FEW_WORKERS)]
    return fleets, {"uniform": addrs, "nonuniform": addrs, "fewlane": few}


def partition_graph(graphs, g):
    """(durations, out_bytes, src, dst) of phase 5's graph ``g``."""
    if g.startswith("blockwise"):
        return tuple(graphs.blockwise_tensordot(int(g[len("blockwise"):]))[1:])
    n = {"random16384": PART_TASKS, "random32768": LEVELED_TASKS, "random1m": N_TASKS}[g]
    return graphs.random_dag(n, seed=0)


def sm_clock_mhz():
    """The card's highest SM clock, MHz (``nvidia-smi``)."""
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return float(out.stdout.strip())


def _chain_ms(part, run, sm_mhz):
    """The floor the contract puts under K4's load pass, whatever its
    design: a lane's load is its tasks' durations added in task order, a
    chain of dependent f32 adds.  Per round the fullest lane's chain, at
    FADD_CYCLES an add and the SM clock.  The labels at each round's start
    are the kernel's after that many rounds (equal to the plain version's)."""
    iters, adds = run.iters, 0
    try:
        for r in range(iters):
            run.iters = r
            part.partition_cuda(run)
            adds += int(np.bincount(run.result(), minlength=run.W).max())
    finally:
        run.iters = iters
    part.partition_cuda(run)
    return adds * FADD_CYCLES / (sm_mhz * 1e3)


def _comm_volume(labels, src, dst):
    """Unique (producer, consumer-lane) cross pairs: the peer fetches after
    replica caching (tests/test_partition.py's measure)."""
    cross = labels[src] != labels[dst]
    return len(set(zip(src[cross].tolist(), labels[dst[cross]].tolist())))


def _max_load(labels, durations, W):
    return float(np.bincount(labels, weights=durations, minlength=W).max())


def _k4_bound_ms(run):
    """Least time for the rounds: each input read once (durations, initial
    labels, the edges' two endpoints and weight), the labels written once;
    and the operations these inputs need, not the dense [T, W] form: per
    round an add a task for the loads, an add an edge in each direction
    for the scores, and a compare a lane for the blocked flags and one for
    the first unblocked lane (a task's best lane among those its edges do
    not touch); for each task of the round's parity the bonus (a max and
    an add) and its first maximum over the candidates: a compare for each
    lane its edges touch, its own lane and its first unblocked lane that
    no edge touches (at most one more than its edges)."""
    T, E, W, R = run.T, run.E, run.W, run.iters
    _, _, src, dst = run.host
    deg = np.bincount(src, minlength=T) + np.bincount(dst, minlength=T)
    row_ops = [int(2 * deg[p::2].sum()) + 4 * len(deg[p::2]) for p in (0, 1)]
    nbytes = 3 * 4 * T + 3 * 4 * E
    ops = R * (T + 2 * E + 2 * W) + sum(row_ops[it % 2] for it in range(R))
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_FLOPS[torch.float32] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_partition(wave_entry, hints_1m):
    """Phase 5: the scheduler's placement extension, ``TorchPlacement``, as
    its planner thread calls it (``_plan_from_arrays``): graphs the router
    sends to the partitioner (kernel K4) and, past DENSE_LIMIT, to the
    leveled engine (K1), whose launches here join ``wave_entry``'s."""
    from distributed_tpu_torch import graphs
    from distributed_tpu_torch.ops import leveled
    from distributed_tpu_torch.ops import partition as part
    from distributed_tpu_torch.scheduler import plan
    from distributed_tpu_torch.scheduler.torch_placement import TorchPlacement

    card = smi_line()
    sm_mhz = sm_clock_mhz()
    fleets, addrs = partition_fleets()
    plans = PART_PLANS + [("random32768", "uniform"), ("random32768", "nonuniform")]
    cases = {g: partition_graph(graphs, g) for g, _ in plans}
    routed = {g: "leveled" if g == "random32768" else "partition" for g in cases}
    keys = {g: [f"{g}-{i}" for i in range(len(c[0]))] for g, c in cases.items()}
    placement = TorchPlacement(sync=True)
    check(placement.device.type == "cuda", f"TorchPlacement on {placement.device}")

    def plan_args(g, f):
        return (keys[g], *cases[g], *fleets[f], addrs[f], BANDWIDTH, LATENCY)

    # the main path, as the planner thread plans each batch
    part.partition_cuda.launches = 0
    leveled.place_waves_cuda.launches = 0
    main, walls = {}, {}
    for g, f in plans:
        t0 = time.perf_counter()
        main[g, f] = placement._plan_from_arrays(*plan_args(g, f))
        torch.cuda.synchronize()
        walls[g, f] = (time.perf_counter() - t0) * 1e3
    k4_launches = part.partition_cuda.launches
    k1_launches = leveled.place_waves_cuda.launches
    n_part = sum(routed[g] == "partition" for g, _ in main)
    n_lev = len(main) - n_part
    check(k4_launches == n_part * K4_LAUNCHES_PER_PLAN,
          f"K4 launches {k4_launches} != {n_part} partitions x {K4_LAUNCHES_PER_PLAN}")
    # below min_stream the streamed driver packs and makes one launch
    check(k1_launches == n_lev, f"K1 launches {k1_launches} != {n_lev} leveled plans")
    check(placement.enabled, "the planner disabled itself")
    wave_entry["launches"] += k1_launches
    wave_entry["launches_extension"] = k1_launches
    print(f"[{card}] placement extension main path: K4 launches {k4_launches} "
          f"({n_part} partitions x {K4_LAUNCHES_PER_PLAN}), K1 launches {k1_launches}")

    cases_out, err_max = {}, 0.0
    for (g, f), hints in main.items():
        durations, out_bytes, src, dst = cases[g]
        nthreads, _, running = fleets[f]
        T = len(durations)
        lanes = [int(w) for w in np.flatnonzero(running)
                 for _ in range(max(int(nthreads[w]), 1))]
        W = len(lanes)
        follows = sum(fk is not None for fk, _ in hints.values())
        check(len(hints) == T, f"{g} {f}: {len(hints)} hints")
        check(set(a for _, a in hints.values()) <= set(addrs[f]), f"{g} {f}: foreign addresses")
        want_route = "partition" if part._bucket(T) * W <= part.DENSE_LIMIT else "leveled"
        check(want_route == routed[g], f"{g} {f}: routed {want_route}, expected {routed[g]}")
        check((follows == 0) == (routed[g] == "partition"), f"{g} {f}: {follows} follow hints")
        t0 = time.perf_counter()
        cpu_hints = TorchPlacement(sync=True, device="cpu")._plan_from_arrays(*plan_args(g, f))
        cpu_s = time.perf_counter() - t0
        check(hints == cpu_hints, f"{g} {f}: hints differ from the CPU run")
        if routed[g] != "partition":
            print(f"[{card}] plan {g} {f}: T {T} lanes {W} -> leveled engine, hints == CPU run, "
                  f"wall_ms {walls[g, f]:.2f}")
            continue

        # K4 against the plain version on the CPU, bit for bit
        weights = (out_bytes[src] / BANDWIDTH + LATENCY).astype(np.float32)
        run = part.PartitionRun(durations, weights, src, dst, W)
        part.partition_cuda(run)
        labels = run.result()
        cpu = part.PartitionRun(durations, weights, src, dst, W, device="cpu")
        part.partition_reference(cpu)
        labels_cpu = cpu.result()
        check(np.array_equal(labels, labels_cpu), f"{g} {f}: K4 labels differ from the CPU run "
              f"({int((labels != labels_cpu).sum())} of {T})")
        load_k = np.bincount(labels, weights=durations.astype(np.float64), minlength=W)
        load_c = np.bincount(labels_cpu, weights=durations.astype(np.float64), minlength=W)
        err = float(np.abs(load_k - load_c).max())
        err_max = max(err_max, err)
        # the plain version on the card, deterministic
        card_run = part.PartitionRun(durations, weights, src, dst, W)
        with deterministic():
            part.partition_reference(card_run)
        labels_p = card_run.result()
        vol_k, vol_p = _comm_volume(labels, src, dst), _comm_volume(labels_p, src, dst)
        vol_b = _comm_volume(part.block_init(durations, W), src, dst)
        ml_k, ml_p = _max_load(labels, durations, W), _max_load(labels_p, durations, W)
        agree = float((labels == labels_p).mean())
        check(abs(vol_k - vol_p) <= K4_RTOL * vol_p, f"{g} {f}: comm volume {vol_k} vs plain {vol_p}")
        check(ml_k <= ml_p * (1 + K4_RTOL), f"{g} {f}: max lane load {ml_k} vs plain {ml_p}")
        check(vol_k < vol_b, f"{g} {f}: comm volume {vol_k} does not beat the blocks' {vol_b}")

        ms = cuda_ms(lambda: part.partition_cuda(run))
        plain_ms = cuda_ms(lambda: part.partition_reference(card_run), reps=5, warmup=1)
        bound_ms, bound_by = _k4_bound_ms(run)
        chain_ms = _chain_ms(part, run, sm_mhz)
        t0 = time.perf_counter()
        plan.hints_from_partition(keys[g], labels, lanes, addrs[f])
        hints_ms = (time.perf_counter() - t0) * 1e3
        plan_ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            placement._plan_from_arrays(*plan_args(g, f))
            plan_ms.append((time.perf_counter() - t0) * 1e3)
        avg_load = float(durations.sum()) / W
        print(f"[{card}] partition {g} {f}: T {T} E {len(src)} lanes {W}: labels == CPU run "
              f"({cpu_s:.2f} s), plain on the card agreement {agree:.6f}, comm volume {vol_k} "
              f"(plain {vol_p}, blocks {vol_b}), max lane load / avg {ml_k / avg_load:.4f} "
              f"(plain {ml_p / avg_load:.4f}); K4 kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
              f"bound_ms {bound_ms:.7f} ({bound_by}) chain_ms {chain_ms:.4f}; plan wall_ms main {walls[g, f]:.2f} "
              f"median {statistics.median(plan_ms):.2f} hints_ms {hints_ms:.2f}")
        cases_out[f"{g}_{f}"] = dict(
            T=T, E=len(src), lanes=W, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, chain_ms=chain_ms, comm_volume=vol_k, comm_volume_plain=vol_p,
            comm_volume_blocks=vol_b, max_load_ratio=ml_k / avg_load,
            max_load_ratio_plain=ml_p / avg_load, card_plain_agreement=agree,
            plan_wall_ms_main=walls[g, f], plan_wall_ms=statistics.median(plan_ms),
            hints_ms=hints_ms)
        del run, cpu, card_run
        torch.cuda.empty_cache()

    # the 1M-task uniform batch through the extension: phase 4's hints
    t0 = time.perf_counter()
    hints = placement._plan_from_arrays([f"task-{i}" for i in range(N_TASKS)],
                                        *cases["random1m"], *fleets["uniform"],
                                        addrs["uniform"], BANDWIDTH, LATENCY)
    wall_1m = (time.perf_counter() - t0) * 1e3
    check(hints == hints_1m, "1M-task hints through TorchPlacement differ from phase 4's")
    print(f"[{card}] placement extension 1M tasks uniform: hints == phase 4's, "
          f"_plan_from_arrays wall_ms {wall_1m:.1f}")
    check(placement.enabled, "the planner disabled itself")

    head = cases_out["blockwise24_uniform"]
    return {
        "name": "partition",
        "route": "cuda",
        "source": "distributed_tpu_torch/ops/csrc/partition.cu",
        "replaces": "distributed_tpu/ops/partition.py:271",
        "launches": k4_launches,
        "max_abs_err": err_max,
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": None,
        "case": "blockwise24_uniform",
        "cases": cases_out,
        "plan_1m_wall_ms": wall_1m,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import distributed_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: distributed_tpu_torch not found; run from the "
              "repository root", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    phase_env()
    k3_ptxas = phase_build()
    flash_entry = phase_flash()
    bwd_entry = phase_flash_bwd(flash_entry, k3_ptxas)
    wave_entry, oneshot = phase_placement()
    hints_1m = phase_streamed(wave_entry, oneshot)
    partition_entry = phase_partition(wave_entry, hints_1m)
    kernels = [flash_entry, bwd_entry, wave_entry, partition_entry]
    print(f"total_s {time.perf_counter() - t0:.1f}")
    print(smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
