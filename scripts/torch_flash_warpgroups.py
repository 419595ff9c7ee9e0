"""Time the port's bf16 ``flash_forward`` kernel with one and with two
consumer warpgroups a block, on a CUDA card.

``csrc/flash_forward.cu`` picks the count per head width
(``warpgroups<HDP>()``); built with ``-DFLASH_WGMMA_WARPGROUPS=<n>`` it
uses ``n`` at every width.  This script builds both counts, checks each
against ``scaled_dot_product_attention`` (bf16 tolerance 3e-2), and times
them in turns (1, 2, 2, 1), each time by replaying 20 launches from one
CUDA graph (the device's time), at causal GQA prefill shapes of the
repo's configs at head widths 64, 96 and 128.  Run from the repository
root:

    PYTHONPATH=src python scripts/torch_flash_warpgroups.py
"""
from __future__ import annotations

import subprocess

import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from repro_torch.configs import get_config
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention_kernel import flash_forward

TOL_BF16 = 3e-2
FUSED_SDPA = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
              SDPBackend.CUDNN_ATTENTION]
REPS = 20
# (config, batch, sequence length)
SHAPES = [("smollm_360m", 8, 1024), ("smollm_360m", 1, 32768),
          ("phi3_mini_3_8b", 8, 1024), ("starcoder2_3b", 8, 1024),
          ("starcoder2_3b", 1, 32768)]


def use_warpgroups(n: int) -> None:
    """Make the next ``flash_forward`` launch a library built with ``n``
    consumer warpgroups a block."""
    build.NVCC_FLAGS = BASE_FLAGS + (f"-DFLASH_WGMMA_WARPGROUPS={n}",)
    build._LOADED.pop("flash_forward", None)


def device_ms(fn) -> float:
    """Milliseconds per call: REPS calls captured in one CUDA graph,
    replayed and timed by CUDA events after an eager warm-up."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(REPS):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def main() -> None:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, B, S in SHAPES:
        cfg = get_config(name)
        H, K, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
        q, k, v = (torch.randn(B * n, S, hd, generator=gen, device="cuda",
                               dtype=torch.bfloat16)
                   for n in (H, K, K))
        k_r, v_r = (t.view(B, K, S, hd).repeat_interleave(H // K, dim=1)
                    for t in (k, v))
        with sdpa_kernel(FUSED_SDPA):    # never the math backend's S x S
            want = F.scaled_dot_product_attention(
                q.view(B, H, S, hd), k_r, v_r, is_causal=True).view_as(q)
        del k_r, v_r
        times = {1: [], 2: []}
        for n in (1, 2, 2, 1):
            use_warpgroups(n)
            got = flash_forward(q, k, v, n_rep=H // K)
            err = float((got.float() - want.float()).abs().max())
            if err > TOL_BF16:
                raise AssertionError(f"{name} S={S}, {n} warpgroups: max "
                                     f"|diff| vs SDPA {err}")
            times[n].append(device_ms(
                lambda: flash_forward(q, k, v, n_rep=H // K)))
        print(f"{name} B={B} H={H}/{K} S={S} hd={hd} bf16 causal: one "
              f"warpgroup a block {times[1][0]:.4f}, {times[1][1]:.4f} ms; "
              f"two {times[2][0]:.4f}, {times[2][1]:.4f} ms [{card}]")


BASE_FLAGS = build.NVCC_FLAGS

if __name__ == "__main__":
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    main()
