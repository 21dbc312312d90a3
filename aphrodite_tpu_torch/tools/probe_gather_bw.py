"""Pure page-gather bandwidth probe (counterpart of tools/probe_gather_bw.py):
what can scattered 64 KB page reads reach on this card? It isolates the
read side of the decode attention kernel (no matmuls, no softmax): it
reads the pages the kernel would and reduces them to one number.

    python -m aphrodite_tpu_torch.tools.probe_gather_bw

Env: PROBE_S (sequences, a multiple of 8; default 128), PROBE_KV_LEN
(tokens per sequence; default 192), PROBE_SEQ=1 (sequential page ids).
It prints the probe's time per call and its rate in GB/s, beside its
plain version, one library call (``index_select`` of the same pages and
a sum) and the bound at 3.35 TB/s.

- ``ref_gather``: the plain PyTorch version, the CPU path and the
  reference the kernel is held against.
- ``gather``: the dispatching wrapper. CPU tensors take the plain
  version; CUDA tensors launch the hand-written Hopper kernel
  ``csrc/gather_probe.cu`` (which replaces the TPU kernel
  tools/probe_gather_bw.py: gather) or raise. Its source says how it is
  bound and what it does about it.

The value, as the TPU kernel computes it at equal kv lengths: for each
block b of G = 8 sequences, f32[8, 128] filled with the sum over the
waves w (C = 8 pages each) that sequence 8b reaches of
sum_d kv_pages[page_indices[8b, 8w], 0, 0, d]. Each row sum is taken in
f64 (exact for these values) and rounded to f32; the waves add up in f32,
in order. With unequal lengths in a block the TPU kernel also adds stale
rows for the waves sequence 8b does not reach; here they add nothing.
"""

import functools
import os

import torch

from aphrodite_tpu_torch.ops import cuda_build
from aphrodite_tpu_torch.tools.kernel_ab import time_ms

S = int(os.environ.get("PROBE_S", "128"))
KV_LEN = int(os.environ.get("PROBE_KV_LEN", "192"))
NKV, D, PAGE = 8, 128, 16
PPS = 128
NUM_PAGES = 4096
G, C = 8, 8
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3


def ref_gather(kv_lens: torch.Tensor, page_indices: torch.Tensor,
               kv_pages: torch.Tensor) -> torch.Tensor:
    """The plain version: f32 [S / G, 8, 128]."""
    ps = kv_pages.shape[1]
    pps = page_indices.shape[1]
    lens = kv_lens[::G].long()  # the first sequence of each block
    n_pages = torch.clamp((lens + ps - 1) // ps, max=pps)
    wave_pages = page_indices[::G, ::C].long()  # [S / G, waves]
    live = (torch.arange(wave_pages.shape[1], device=lens.device)[None, :]
            * C < n_pages[:, None])
    rows = kv_pages[wave_pages, 0, 0, :].double().sum(-1).float()
    rows = torch.where(live, rows, torch.zeros_like(rows))
    acc = torch.zeros(rows.shape[0], dtype=torch.float32, device=rows.device)
    for w in range(rows.shape[1]):
        acc = acc + rows[:, w]
    return acc[:, None, None].expand(-1, 8, 128).contiguous()


@functools.lru_cache(maxsize=None)
def _kernel():
    import ctypes

    fn = cuda_build.load("gather_probe").gather_probe
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def gather(kv_lens: torch.Tensor, page_indices: torch.Tensor,
           kv_pages: torch.Tensor) -> torch.Tensor:
    """The probe over kv_lens i32[S], page_indices i32[S, PPS] and bf16
    pages [P, page_size, 2 * KV, D]: f32 [S / G, 8, 128]."""
    if kv_pages.device.type == "cpu":
        return ref_gather(kv_lens, page_indices, kv_pages)
    num_seqs = kv_lens.shape[0]
    if (kv_pages.dtype != torch.bfloat16 or not kv_pages.is_contiguous()
            or kv_pages.data_ptr() % 16 or num_seqs % G
            or page_indices.shape[0] != num_seqs
            or any(t.device != kv_pages.device or t.dtype != torch.int32
                   or not t.is_contiguous()
                   for t in (kv_lens, page_indices))):
        raise ValueError(
            "gather_probe kernel takes contiguous bf16 pages, 16-byte "
            "aligned, and contiguous int32 kv_lens [S] and page_indices "
            f"[S, pages] on their device with S a multiple of {G}; got "
            f"{kv_pages.dtype} pages on {kv_pages.device}, kv_lens "
            f"{tuple(kv_lens.shape)}, page_indices "
            f"{tuple(page_indices.shape)}")
    _, page_size, _, head_dim = kv_pages.shape
    out = torch.empty((num_seqs // G, 8, 128), dtype=torch.float32,
                      device=kv_pages.device)
    checksum = torch.empty((num_seqs, C), dtype=torch.int32,
                           device=kv_pages.device)
    page_bytes = kv_pages[0].numel() * kv_pages.element_size()
    err = _kernel()(kv_lens.data_ptr(), page_indices.data_ptr(),
                    kv_pages.data_ptr(), out.data_ptr(), checksum.data_ptr(),
                    num_seqs, page_indices.shape[1], page_size, page_bytes,
                    head_dim,
                    torch.cuda.current_stream(kv_pages.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gather_probe kernel: CUDA error {err}")
    gather.launches += 1
    return out


gather.launches = 0


def make_inputs(device, seed: int = 0):
    """The probe's inputs: NUM_PAGES pages at std 0.1 (bf16), kv_lens of
    KV_LEN for S sequences, and each sequence's pages drawn without
    replacement from the first NUM_PAGES - 1 (PROBE_SEQ=1: consecutive
    ids)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    kv_pages = (torch.randn((NUM_PAGES, PAGE, 2 * NKV, D), generator=gen)
                * 0.1).to(torch.bfloat16).to(device)
    kv_lens = torch.full((S,), KV_LEN, dtype=torch.int32, device=device)
    used = -(-KV_LEN // PAGE)
    pi = torch.zeros((S, PPS), dtype=torch.int32)
    sequential = os.environ.get("PROBE_SEQ", "0") == "1"
    for i in range(S):
        if sequential:
            pi[i, :used] = (torch.arange(used) + i * used) % (NUM_PAGES - 1)
        else:
            pi[i, :used] = torch.randperm(NUM_PAGES - 1, generator=gen)[:used]
    return kv_lens, pi.to(device), kv_pages, sequential


def probe_bytes(kv_lens: torch.Tensor, kv_pages: torch.Tensor) -> int:
    """Bytes one call must move: every live page once, the index tensors
    it reads and the output."""
    ps = kv_pages.shape[1]
    page_bytes = kv_pages[0].numel() * kv_pages.element_size()
    pages = int(((kv_lens.long() + ps - 1) // ps).clamp(max=PPS).sum())
    return (pages * page_bytes + kv_lens.numel() * 4 * (1 + PPS)
            + kv_lens.numel() // G * 8 * 128 * 4)


def measure(iters: int = 200) -> dict:
    """Times the kernel, its plain version and the library call at the
    probe's shapes (the kernel is held against its plain version by
    tests/test_torch_cuda.py and chip_smoke.py)."""
    if not torch.cuda.is_available():
        raise RuntimeError("probe_gather_bw: needs a card")
    kv_lens, page_indices, kv_pages, sequential = make_inputs("cuda")
    used = -(-KV_LEN // PAGE)
    ids = page_indices[:, :used].reshape(-1).long()
    nbytes = probe_bytes(kv_lens, kv_pages)
    ms = time_ms(lambda: gather(kv_lens, page_indices, kv_pages), iters)
    plain_ms = time_ms(lambda: ref_gather(kv_lens, page_indices, kv_pages),
                       max(1, iters // 10))
    library_ms = time_ms(
        lambda: kv_pages.index_select(0, ids).sum(dtype=torch.float32),
        iters)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                bytes=nbytes, sequential=sequential,
                shape=f"S {S}, kv_len {KV_LEN}, {NKV} kv heads, D {D}, "
                      f"page {PAGE}, {NUM_PAGES} pages")


def main() -> dict:
    """Runs the probe and prints its rate; returns what ``measure``
    measured."""
    r = measure()
    mb = r["bytes"] / 1e6
    print(f"gather_probe: {r['ms'] * 1e3:8.1f} us/call "
          f"({r['bytes'] / (r['ms'] * 1e-3) / 1e9:6.0f} GB/s) "
          f"[{mb:.0f} MB, seq={r['sequential']}]; plain "
          f"{r['plain_ms'] * 1e3:.1f} us, library (index_select + sum) "
          f"{r['library_ms'] * 1e3:.1f} us, bound {r['bound_ms'] * 1e3:.1f} "
          f"us on {torch.cuda.get_device_name(0)}", flush=True)
    return r


if __name__ == "__main__":
    main()
