"""GGUF checkpoint loading: parser and block decoders (a copy of
aphrodite_tpu/loader/gguf.py, rewritten in its imports and in what must
return tensors).

The file format and block layouts follow the public ggml spec. Every
quantized block type maps losslessly onto the grouped container
``{q4 [K, N] int8 levels, scale [K/G, N], zero [K/G, N]}`` of
quantization/qlinear.py, because ggml's  w = d*sc*q - dmin*m  is exactly
(q - zero)*scale with scale = d*sc, zero = dmin*m/(d*sc). Levels that fit
a nibble (Q4_0, Q4_1, Q4_K, Q2_K, Q3_K) are packed two to a byte
(``q4p``) where the group alignment allows; Q5, Q6, Q8 and the IQ types
keep one level per byte (``q4``). Both kinds serve weight-quantized
through the kernels of ops/quant_matmul.py. Embeddings, norms and the
output head dequantize to float at load.

The decoders work on numpy arrays; ``load_gguf_params_to_host`` returns
CPU tensors, as the port's other loaders do. No external ``gguf``
package is used; the parser takes GGUF v2/v3 little-endian files.
"""

import struct
from typing import Any, BinaryIO, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from aphrodite_tpu_torch.common.logger import init_logger

logger = init_logger(__name__)

GGUF_MAGIC = 0x46554747  # "GGUF"

# IQ4_NL / IQ4_XS non-linear 4-bit level table (public ggml format
# constant `kvalues_iq4nl`; every GGUF implementation carries these
# sixteen values verbatim — they define the format, like fp8's bias).
KVALUES_IQ4NL = np.array(
    [-127, -104, -83, -65, -49, -35, -22, -10, 1, 13, 25, 38, 53, 69,
     89, 113], dtype=np.int8)

# Epsilon scale substituted for zero-scale groups that still carry a
# min offset (power of two: (q - m/eps)*eps == q*eps - m exactly in
# f32 up to one subtraction rounding).
_EPS_SCALE = 2.0 ** -20


def _min_offset_zero(scale: np.ndarray, offset: np.ndarray):
    """Container (scale, zero) for ggml's  w = scale*q - offset  form.

    zero = offset/scale, EXCEPT groups where d*sc == 0 but the dmin*m
    offset isn't: the reference CUDA dequant still emits y = -m for
    those (e.g. kernels/quantization/gguf CUDA paths), so a plain 0
    scale would drop the constant. Clamp such groups' scale to
    2^-20 with zero = offset/2^-20, which decodes to
    q*2^-20 - offset ~= -offset (error <= 31*2^-20, far below f16
    weight precision)."""
    need_eps = (scale == 0) & (offset != 0)
    scale = np.where(need_eps, _EPS_SCALE, scale)
    zero = np.where(scale != 0,
                    offset / np.where(scale == 0, 1.0, scale), 0.0)
    return scale, zero

# Metadata value types.
_T_U8, _T_I8, _T_U16, _T_I16, _T_U32, _T_I32 = 0, 1, 2, 3, 4, 5
_T_F32, _T_BOOL, _T_STR, _T_ARR, _T_U64, _T_I64, _T_F64 = (
    6, 7, 8, 9, 10, 11, 12)

# ggml tensor types (subset).
GGML_F32, GGML_F16 = 0, 1
GGML_Q4_0, GGML_Q4_1 = 2, 3
GGML_Q5_0, GGML_Q5_1 = 6, 7
GGML_Q8_0 = 8
GGML_Q2_K, GGML_Q3_K, GGML_Q4_K, GGML_Q5_K, GGML_Q6_K = 10, 11, 12, 13, 14
GGML_IQ2_XXS, GGML_IQ2_XS, GGML_IQ3_XXS = 16, 17, 18
GGML_IQ1_S, GGML_IQ4_NL, GGML_IQ3_S, GGML_IQ2_S, GGML_IQ4_XS = (
    19, 20, 21, 22, 23)
GGML_IQ1_M = 29
GGML_BF16 = 30

QK_K = 256
# type -> (block_elems, block_bytes)
BLOCK_INFO = {
    GGML_F32: (1, 4),
    GGML_F16: (1, 2),
    GGML_BF16: (1, 2),
    GGML_Q4_0: (32, 18),
    GGML_Q4_1: (32, 20),
    GGML_Q5_0: (32, 22),
    GGML_Q5_1: (32, 24),
    GGML_Q8_0: (32, 34),
    GGML_Q2_K: (QK_K, 84),
    GGML_Q3_K: (QK_K, 110),
    GGML_Q4_K: (QK_K, 144),
    GGML_Q5_K: (QK_K, 176),
    GGML_Q6_K: (QK_K, 210),
    # i-quants (reference gguf_utils/constants.py:738-822 type table).
    GGML_IQ2_XXS: (QK_K, 2 + QK_K // 4),
    GGML_IQ2_XS: (QK_K, 2 + QK_K // 4 + QK_K // 32),
    GGML_IQ3_XXS: (QK_K, 2 + QK_K // 4 + QK_K // 8),
    GGML_IQ1_S: (QK_K, 2 + QK_K // 8 + QK_K // 16),
    GGML_IQ4_NL: (32, 18),
    GGML_IQ3_S: (QK_K, 2 + QK_K // 4 + QK_K // 8 + QK_K // 32 + 4),
    GGML_IQ2_S: (QK_K, 2 + QK_K // 4 + QK_K // 16),
    GGML_IQ4_XS: (QK_K, 2 + 2 + QK_K // 2 + QK_K // 64),
    GGML_IQ1_M: (QK_K, QK_K // 8 + QK_K // 16 + QK_K // 32),
}


def _read_str(f: BinaryIO) -> str:
    n = struct.unpack("<Q", f.read(8))[0]
    return f.read(n).decode("utf-8", errors="replace")


def _read_value(f: BinaryIO, vtype: int):
    if vtype == _T_U8:
        return struct.unpack("<B", f.read(1))[0]
    if vtype == _T_I8:
        return struct.unpack("<b", f.read(1))[0]
    if vtype == _T_U16:
        return struct.unpack("<H", f.read(2))[0]
    if vtype == _T_I16:
        return struct.unpack("<h", f.read(2))[0]
    if vtype == _T_U32:
        return struct.unpack("<I", f.read(4))[0]
    if vtype == _T_I32:
        return struct.unpack("<i", f.read(4))[0]
    if vtype == _T_F32:
        return struct.unpack("<f", f.read(4))[0]
    if vtype == _T_BOOL:
        return bool(f.read(1)[0])
    if vtype == _T_STR:
        return _read_str(f)
    if vtype == _T_U64:
        return struct.unpack("<Q", f.read(8))[0]
    if vtype == _T_I64:
        return struct.unpack("<q", f.read(8))[0]
    if vtype == _T_F64:
        return struct.unpack("<d", f.read(8))[0]
    if vtype == _T_ARR:
        etype = struct.unpack("<I", f.read(4))[0]
        n = struct.unpack("<Q", f.read(8))[0]
        return [_read_value(f, etype) for _ in range(n)]
    raise ValueError(f"unknown gguf metadata type {vtype}")


class GGUFTensorInfo:
    def __init__(self, name: str, dims: List[int], ggml_type: int,
                 offset: int):
        self.name = name
        self.dims = dims  # ggml order: dims[0] is contiguous (row length)
        self.ggml_type = ggml_type
        self.offset = offset


class GGUFFile:
    """Parsed GGUF: metadata dict + lazy tensor access via memmap."""

    def __init__(self, path: str) -> None:
        self.path = path
        self.metadata: Dict[str, Any] = {}
        self.tensors: Dict[str, GGUFTensorInfo] = {}
        with open(path, "rb") as f:
            magic, version = struct.unpack("<II", f.read(8))
            if magic != GGUF_MAGIC:
                raise ValueError(f"{path} is not a GGUF file")
            if version not in (2, 3):
                raise ValueError(f"unsupported GGUF version {version}")
            n_tensors, n_kv = struct.unpack("<QQ", f.read(16))
            for _ in range(n_kv):
                key = _read_str(f)
                vtype = struct.unpack("<I", f.read(4))[0]
                self.metadata[key] = _read_value(f, vtype)
            for _ in range(n_tensors):
                name = _read_str(f)
                ndim = struct.unpack("<I", f.read(4))[0]
                dims = list(struct.unpack(f"<{ndim}Q", f.read(8 * ndim)))
                ggml_type = struct.unpack("<I", f.read(4))[0]
                offset = struct.unpack("<Q", f.read(8))[0]
                self.tensors[name] = GGUFTensorInfo(name, dims, ggml_type,
                                                    offset)
            align = self.metadata.get("general.alignment", 32)
            pos = f.tell()
            self.data_start = (pos + align - 1) // align * align
        self._mmap = np.memmap(path, dtype=np.uint8, mode="r")

    def raw_blocks(self, info: GGUFTensorInfo) -> np.ndarray:
        """uint8[rows, row_bytes] raw block data for a 2D/1D tensor."""
        elems, bbytes = BLOCK_INFO[info.ggml_type]
        row_len = info.dims[0]
        rows = int(np.prod(info.dims[1:])) if len(info.dims) > 1 else 1
        assert row_len % elems == 0, (info.name, row_len, elems)
        row_bytes = row_len // elems * bbytes
        start = self.data_start + info.offset
        data = self._mmap[start:start + rows * row_bytes]
        return np.asarray(data).reshape(rows, row_bytes)


# ---------------------------------------------------------------------------
# Block decoders. All operate on uint8[rows, row_bytes] -> per-row output.
# ---------------------------------------------------------------------------


def _f16(u8pair: np.ndarray) -> np.ndarray:
    return u8pair.view(np.float16).astype(np.float32)


def decode_f32(raw: np.ndarray, row_len: int) -> np.ndarray:
    return raw.view(np.float32).reshape(-1, row_len)


def decode_f16(raw: np.ndarray, row_len: int) -> np.ndarray:
    return raw.view(np.float16).astype(np.float32).reshape(-1, row_len)


def decode_bf16(raw: np.ndarray, row_len: int) -> np.ndarray:
    # bf16 is the high half of an f32: widen by a 16-bit shift (exact).
    return (raw.view(np.uint16).astype(np.uint32) << 16).view(
        np.float32).reshape(-1, row_len)


def decode_q8_0(raw: np.ndarray, row_len: int) -> np.ndarray:
    """block: d f16 + 32 int8; w = d * q."""
    rows = raw.shape[0]
    blocks = raw.reshape(rows, -1, 34)
    d = blocks[:, :, :2].reshape(rows, -1, 2).copy().view(
        np.float16).astype(np.float32)  # [rows, nb, 1]
    q = blocks[:, :, 2:].copy().view(np.int8).astype(np.float32)
    return (d * q).reshape(rows, row_len)


def decode_q4_0_container(raw: np.ndarray, row_len: int):
    """Q4_0 -> int4 container pieces (q [rows,row_len], scale, zero with
    group 32). w = d * (q - 8)."""
    rows = raw.shape[0]
    blocks = raw.reshape(rows, -1, 18)
    d = blocks[:, :, :2].reshape(rows, -1, 2).copy().view(
        np.float16).astype(np.float32)[:, :, 0]  # [rows, nb]
    qs = blocks[:, :, 2:]  # [rows, nb, 16]
    lo = (qs & 0xF).astype(np.int8)
    hi = (qs >> 4).astype(np.int8)
    # ggml q4_0 layout: value j in 0..15 from low nibble, 16..31 high.
    q = np.concatenate([lo, hi], axis=2).reshape(rows, row_len)
    scale = d
    zero = np.full_like(scale, 8.0)
    return q, scale, zero


def decode_q4_1_container(raw: np.ndarray, row_len: int):
    """Q4_1: w = d * q + m -> zero = -m/d."""
    rows = raw.shape[0]
    blocks = raw.reshape(rows, -1, 20)
    d = blocks[:, :, :2].reshape(rows, -1, 2).copy().view(
        np.float16).astype(np.float32)[:, :, 0]
    m = blocks[:, :, 2:4].reshape(rows, -1, 2).copy().view(
        np.float16).astype(np.float32)[:, :, 0]
    qs = blocks[:, :, 4:]
    lo = (qs & 0xF).astype(np.int8)
    hi = (qs >> 4).astype(np.int8)
    q = np.concatenate([lo, hi], axis=2).reshape(rows, row_len)
    safe_d = np.where(d == 0, 1e-8, d)
    return q, d, -m / safe_d


def _q4k_scale_min(scales: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Unpack the 12-byte 6-bit scale/min table of Q4_K/Q5_K
    (ggml get_scale_min_k4): 8 (sc, m) pairs per super-block."""
    # scales: [rows, nsb, 12] uint8
    sc = np.zeros(scales.shape[:2] + (8,), np.float32)
    mn = np.zeros_like(sc)
    s = scales.astype(np.uint16)
    for j in range(4):
        sc[:, :, j] = (s[:, :, j] & 63).astype(np.float32)
        mn[:, :, j] = (s[:, :, j + 4] & 63).astype(np.float32)
    for j in range(4, 8):
        sc[:, :, j] = ((s[:, :, j + 4] & 0xF) |
                       ((s[:, :, j - 4] >> 6) << 4)).astype(np.float32)
        mn[:, :, j] = ((s[:, :, j + 4] >> 4) |
                       ((s[:, :, j] >> 6) << 4)).astype(np.float32)
    return sc, mn


def decode_q4_k_container(raw: np.ndarray, row_len: int):
    """Q4_K super-block (256): d f16, dmin f16, scales[12], qs[128].
    Sub-block j (32 values): w = (d*sc_j) * q - (dmin*m_j)
    -> container scale = d*sc_j, zero = dmin*m_j / (d*sc_j)."""
    rows = raw.shape[0]
    blocks = raw.reshape(rows, -1, 144)
    nsb = blocks.shape[1]
    d = blocks[:, :, 0:2].reshape(rows, -1, 2).copy().view(
        np.float16).astype(np.float32)[:, :, 0]  # [rows, nsb]
    dmin = blocks[:, :, 2:4].reshape(rows, -1, 2).copy().view(
        np.float16).astype(np.float32)[:, :, 0]
    sc, mn = _q4k_scale_min(blocks[:, :, 4:16])  # [rows, nsb, 8]
    qs = blocks[:, :, 16:144]  # [rows, nsb, 128]
    # Layout: 4 chunks of 32 bytes; chunk c holds sub-blocks 2c (low
    # nibbles) and 2c+1 (high nibbles).
    qs = qs.reshape(rows, nsb, 4, 32)
    lo = (qs & 0xF).astype(np.int8)  # sub-blocks 0,2,4,6
    hi = (qs >> 4).astype(np.int8)  # sub-blocks 1,3,5,7
    q = np.stack([lo, hi], axis=3)  # [rows, nsb, 4, 2, 32]
    q = q.reshape(rows, nsb, 8, 32).reshape(rows, row_len)
    scale, zero = _min_offset_zero(d[:, :, None] * sc,
                                   dmin[:, :, None] * mn)
    scale = scale.reshape(rows, -1)  # group = 32
    zero = zero.reshape(rows, -1)
    return q, scale.astype(np.float32), zero.astype(np.float32)


def decode_q6_k(raw: np.ndarray, row_len: int) -> np.ndarray:
    """Q6_K (256): ql[128], qh[64], scales[16] i8, d f16.
    w = d * sc_j * (q6 - 32), 16 sub-blocks of 16."""
    rows = raw.shape[0]
    blocks = raw.reshape(rows, -1, 210)
    nsb = blocks.shape[1]
    ql = blocks[:, :, 0:128]
    qh = blocks[:, :, 128:192]
    scales = blocks[:, :, 192:208].copy().view(np.int8).astype(np.float32)
    d = blocks[:, :, 208:210].reshape(rows, -1, 2).copy().view(
        np.float16).astype(np.float32)[:, :, 0]
    # ggml layout: per 128-value half (n=0,1): for l in 0..31:
    #   q[l+ 0] = (ql[l]    & 0xF) | ((qh[l] >> 0 & 3) << 4)
    #   q[l+32] = (ql[l+32] & 0xF) | ((qh[l] >> 2 & 3) << 4)
    #   q[l+64] = (ql[l]    >>  4) | ((qh[l] >> 4 & 3) << 4)
    #   q[l+96] = (ql[l+32] >>  4) | ((qh[l] >> 6 & 3) << 4)
    ql = ql.reshape(rows, nsb, 2, 64)
    qh = qh.reshape(rows, nsb, 2, 32)
    l0 = (ql[:, :, :, 0:32] & 0xF) | ((qh & 0x3) << 4)
    l1 = (ql[:, :, :, 32:64] & 0xF) | (((qh >> 2) & 0x3) << 4)
    l2 = (ql[:, :, :, 0:32] >> 4) | (((qh >> 4) & 0x3) << 4)
    l3 = (ql[:, :, :, 32:64] >> 4) | (((qh >> 6) & 0x3) << 4)
    q = np.concatenate([l0, l1, l2, l3], axis=3).astype(np.float32) - 32.0
    # Scales: 16 sub-blocks of 16 values -> within each 128-half there
    # are 8 scale entries (j = half*8 + l//16).
    sc = scales.reshape(rows, nsb, 16)
    sc = np.repeat(sc, 16, axis=2).reshape(rows, nsb, 2, 128)
    out = d[:, :, None, None] * sc * q
    return out.reshape(rows, row_len)


def decode_q6_k_container(raw: np.ndarray, row_len: int):
    """Q6_K -> grouped container: q in [0, 63], G=16, zero = 32,
    scale = d * int8_subscale. Same value layout as decode_q6_k; the
    canonical position p's scale index is simply p // 16."""
    rows = raw.shape[0]
    blocks = raw.reshape(rows, -1, 210)
    nsb = blocks.shape[1]
    ql = blocks[:, :, 0:128].reshape(rows, nsb, 2, 64)
    qh = blocks[:, :, 128:192].reshape(rows, nsb, 2, 32)
    scales = blocks[:, :, 192:208].copy().view(np.int8).astype(np.float32)
    d = blocks[:, :, 208:210].reshape(rows, -1, 2).copy().view(
        np.float16).astype(np.float32)[:, :, 0]
    l0 = (ql[:, :, :, 0:32] & 0xF) | ((qh & 0x3) << 4)
    l1 = (ql[:, :, :, 32:64] & 0xF) | (((qh >> 2) & 0x3) << 4)
    l2 = (ql[:, :, :, 0:32] >> 4) | (((qh >> 4) & 0x3) << 4)
    l3 = (ql[:, :, :, 32:64] >> 4) | (((qh >> 6) & 0x3) << 4)
    q = np.concatenate([l0, l1, l2, l3], axis=3).astype(np.int8)
    q = q.reshape(rows, row_len)
    scale = (d[:, :, None] * scales.reshape(rows, nsb, 16)).reshape(
        rows, -1)  # [rows, row_len/16]
    zero = np.full_like(scale, 32.0)
    return q, scale.astype(np.float32), zero


def decode_q5_k_container(raw: np.ndarray, row_len: int):
    """Q5_K -> grouped container: q in [0, 31], G=32,
    scale = d*sc_j, zero = dmin*m_j / (d*sc_j) (q4_k scale table +
    a fifth bit from qh: chunk c's sub-blocks 2c / 2c+1 take qh bits
    2c / 2c+1)."""
    rows = raw.shape[0]
    blocks = raw.reshape(rows, -1, 176)
    nsb = blocks.shape[1]
    d = blocks[:, :, 0:2].reshape(rows, -1, 2).copy().view(
        np.float16).astype(np.float32)[:, :, 0]
    dmin = blocks[:, :, 2:4].reshape(rows, -1, 2).copy().view(
        np.float16).astype(np.float32)[:, :, 0]
    sc, mn = _q4k_scale_min(blocks[:, :, 4:16])
    qh = blocks[:, :, 16:48]  # [rows, nsb, 32]
    qs = blocks[:, :, 48:176].reshape(rows, nsb, 4, 32)
    parts = []
    for c in range(4):
        lo = (qs[:, :, c] & 0xF) | (((qh >> (2 * c)) & 1) << 4)
        hi = (qs[:, :, c] >> 4) | (((qh >> (2 * c + 1)) & 1) << 4)
        parts.append(np.stack([lo, hi], axis=2))  # [rows, nsb, 2, 32]
    q = np.concatenate(parts, axis=2).astype(np.int8)  # [rows,nsb,8,32]
    q = q.reshape(rows, row_len)
    scale, zero = _min_offset_zero(d[:, :, None] * sc,
                                   dmin[:, :, None] * mn)
    return (q, scale.reshape(rows, -1).astype(np.float32),
            zero.reshape(rows, -1).astype(np.float32))


def decode_q2_k_container(raw: np.ndarray, row_len: int):
    """Q2_K -> grouped container: q in [0, 3], G=16,
    scale = d*(sc & 0xF), zero = dmin*(sc >> 4) / scale."""
    rows = raw.shape[0]
    blocks = raw.reshape(rows, -1, 84)
    nsb = blocks.shape[1]
    scales = blocks[:, :, 0:16]  # [rows, nsb, 16] 4-bit sc | 4-bit min
    qs = blocks[:, :, 16:80].reshape(rows, nsb, 2, 32)  # 2 halves
    d = blocks[:, :, 80:82].reshape(rows, -1, 2).copy().view(
        np.float16).astype(np.float32)[:, :, 0]
    dmin = blocks[:, :, 82:84].reshape(rows, -1, 2).copy().view(
        np.float16).astype(np.float32)[:, :, 0]
    # Half h, shift j in 0..3: values (qs[h, l] >> 2j) & 3, l in 0..31;
    # canonical position within half = 32*j + l; scale idx = pos // 16.
    shifts = np.stack([(qs >> (2 * j)) & 3 for j in range(4)], axis=3)
    # [rows, nsb, 2, 4, 32] -> [rows, nsb, 2, 128]
    q = shifts.reshape(rows, nsb, 2, 128).reshape(rows, row_len)
    q = q.astype(np.int8)
    sc = (scales & 0xF).astype(np.float32)
    mn = (scales >> 4).astype(np.float32)
    scale, zero = _min_offset_zero(d[:, :, None] * sc,
                                   dmin[:, :, None] * mn)
    return (q, scale.reshape(rows, -1).astype(np.float32),
            zero.reshape(rows, -1).astype(np.float32))


def decode_q3_k_container(raw: np.ndarray, row_len: int):
    """Q3_K -> grouped container: q in [0, 7] (2-bit qs + hmask high
    bit), G=16, zero = 4, scale = d * (6-bit subscale - 32)."""
    rows = raw.shape[0]
    blocks = raw.reshape(rows, -1, 110)
    nsb = blocks.shape[1]
    hmask = blocks[:, :, 0:32]  # [rows, nsb, 32]
    qs = blocks[:, :, 32:96].reshape(rows, nsb, 2, 32)
    scales_raw = blocks[:, :, 96:108]  # 12 bytes -> 16 6-bit scales
    d = blocks[:, :, 108:110].reshape(rows, -1, 2).copy().view(
        np.float16).astype(np.float32)[:, :, 0]
    # 6-bit scale unpack (ggml kmask arrangement): aux words.
    a = scales_raw.astype(np.uint32)
    w = [a[..., 4 * i] | (a[..., 4 * i + 1] << 8)
         | (a[..., 4 * i + 2] << 16) | (a[..., 4 * i + 3] << 24)
         for i in range(3)]
    kmask1, kmask2 = 0x03030303, 0x0F0F0F0F
    out_w = [
        (w[0] & kmask2) | (((w[2] >> 0) & kmask1) << 4),
        (w[1] & kmask2) | (((w[2] >> 2) & kmask1) << 4),
        ((w[0] >> 4) & kmask2) | (((w[2] >> 4) & kmask1) << 4),
        ((w[1] >> 4) & kmask2) | (((w[2] >> 6) & kmask1) << 4),
    ]
    sc6 = np.stack(
        [(ww >> (8 * b)) & 0xFF for ww in out_w for b in range(4)],
        axis=2).astype(np.int8)  # [rows, nsb, 16] in aux-word order
    # aux-word order IS scale index order (scales[is], is = 0..15).
    sc = sc6.astype(np.float32) - 32.0
    # Values: half h (qs[:, :, h]), shift j: (qs >> 2j) & 3; high bit
    # from hmask bit m = h*4 + j (m <<= 1 across all 8 sub-shifts).
    qparts = []
    for h in range(2):
        for j in range(4):
            base = (qs[:, :, h] >> (2 * j)) & 3
            mbit = 1 << (h * 4 + j)
            hi = ((hmask & mbit) != 0).astype(np.uint8)
            qparts.append(base + (hi << 2))  # [rows, nsb, 32]
    q = np.stack(qparts, axis=2).reshape(rows, row_len).astype(np.int8)
    scale = (d[:, :, None] * sc).reshape(rows, -1)
    zero = np.full_like(scale, 4.0)
    return q, scale.astype(np.float32), zero


def decode_q5_0_container(raw: np.ndarray, row_len: int):
    """Q5_0: w = d * (q - 16), q 5-bit; G=32."""
    rows = raw.shape[0]
    blocks = raw.reshape(rows, -1, 22)
    d = blocks[:, :, :2].reshape(rows, -1, 2).copy().view(
        np.float16).astype(np.float32)[:, :, 0]
    qh = (blocks[:, :, 2:6].copy().view(np.uint32))[:, :, 0]  # [rows,nb]
    qs = blocks[:, :, 6:22]
    j = np.arange(16, dtype=np.uint32)
    lo = (qs & 0xF) | (((qh[:, :, None] >> j) & 1) << 4).astype(np.uint8)
    hi = (qs >> 4) | (((qh[:, :, None] >> (j + 16)) & 1) << 4).astype(
        np.uint8)
    q = np.concatenate([lo, hi], axis=2).reshape(rows,
                                                 row_len).astype(np.int8)
    zero = np.full_like(d, 16.0)
    return q, d, zero


def decode_q5_1_container(raw: np.ndarray, row_len: int):
    """Q5_1: w = d * q + m; G=32, zero = -m/d."""
    rows = raw.shape[0]
    blocks = raw.reshape(rows, -1, 24)
    d = blocks[:, :, :2].reshape(rows, -1, 2).copy().view(
        np.float16).astype(np.float32)[:, :, 0]
    m = blocks[:, :, 2:4].reshape(rows, -1, 2).copy().view(
        np.float16).astype(np.float32)[:, :, 0]
    qh = (blocks[:, :, 4:8].copy().view(np.uint32))[:, :, 0]
    qs = blocks[:, :, 8:24]
    j = np.arange(16, dtype=np.uint32)
    lo = (qs & 0xF) | (((qh[:, :, None] >> j) & 1) << 4).astype(np.uint8)
    hi = (qs >> 4) | (((qh[:, :, None] >> (j + 16)) & 1) << 4).astype(
        np.uint8)
    q = np.concatenate([lo, hi], axis=2).reshape(rows,
                                                 row_len).astype(np.int8)
    safe_d = np.where(d == 0, 1e-8, d)
    return q, d, -m / safe_d


def decode_q8_0_container(raw: np.ndarray, row_len: int):
    """Q8_0: w = d * q, signed int8; G=32, zero = 0."""
    rows = raw.shape[0]
    blocks = raw.reshape(rows, -1, 34)
    d = blocks[:, :, :2].reshape(rows, -1, 2).copy().view(
        np.float16).astype(np.float32)[:, :, 0]
    q = blocks[:, :, 2:].copy().view(np.int8).reshape(rows, row_len)
    return q, d, np.zeros_like(d)


def decode_iq4_nl_container(raw: np.ndarray, row_len: int):
    """IQ4_NL: w = d * kvalues[nib]. The non-linear levels are
    PRE-MAPPED to their int8 values at load, so the grouped container
    (zero = 0) serves them natively — (q - 0) * d with q already a
    level, not an index."""
    rows = raw.shape[0]
    blocks = raw.reshape(rows, -1, 18)
    d = blocks[:, :, :2].reshape(rows, -1, 2).copy().view(
        np.float16).astype(np.float32)[:, :, 0]
    qs = blocks[:, :, 2:18]
    lo = KVALUES_IQ4NL[qs & 0xF]
    hi = KVALUES_IQ4NL[qs >> 4]
    q = np.concatenate([lo, hi], axis=2).reshape(rows, row_len)
    return q, d, np.zeros_like(d)


def decode_iq4_xs_container(raw: np.ndarray, row_len: int):
    """IQ4_XS: super-block of 256 with per-32 6-bit scales;
    w = d * (sc - 32) * kvalues[nib]. Levels pre-mapped like IQ4_NL."""
    rows = raw.shape[0]
    blocks = raw.reshape(rows, -1, 136)
    nsb = blocks.shape[1]
    d = blocks[:, :, 0:2].reshape(rows, -1, 2).copy().view(
        np.float16).astype(np.float32)[:, :, 0]
    sh = (blocks[:, :, 2:4].copy().view(np.uint16))[:, :, 0]  # [rows,nsb]
    sl = blocks[:, :, 4:8]  # [rows, nsb, 4] 4-bit pairs
    qs = blocks[:, :, 8:136].reshape(rows, nsb, 8, 16)
    js = np.arange(8)
    low = np.stack([(sl[:, :, j // 2] >> (4 * (j % 2))) & 0xF
                    for j in js], axis=2).astype(np.int32)
    high = np.stack([((sh[:, :, None] >> (2 * j)) & 3)[:, :, 0]
                     for j in js], axis=2).astype(np.int32)
    sc = (low | (high << 4)).astype(np.float32) - 32.0  # [rows, nsb, 8]
    lo = KVALUES_IQ4NL[qs & 0xF]  # [rows, nsb, 8, 16]
    hi = KVALUES_IQ4NL[qs >> 4]
    q = np.concatenate([lo, hi], axis=3).reshape(rows, row_len)
    scale = (d[:, :, None] * sc).reshape(rows, -1)  # G = 32
    return q, scale.astype(np.float32), np.zeros_like(scale)


# ---------------------------------------------------------------------------
# Codebook i-quants (IQ1/IQ2/IQ3). Weights live on fixed lattice
# codebooks; the grids are public ggml format constants shipped as a
# 7KB data file (tools/extract_iq_grids.py documents provenance). Signs
# fold into the decoded int8 values and block scales map onto the
# grouped container, so i-quants SERVE natively like everything else.
# ---------------------------------------------------------------------------

_IQ = None


def _iq_tables():
    global _IQ
    if _IQ is None:
        import os

        z = np.load(os.path.join(os.path.dirname(__file__),
                                 "iq_grids.npz"))
        i = np.arange(128, dtype=np.uint8)
        pop = np.unpackbits(i[:, None], axis=1).sum(axis=1)
        _IQ = {
            # uint64/uint32 entries -> little-endian byte vectors, the
            # same layout the C pointer casts read.
            "iq2xxs": z["iq2xxs"].view(np.uint8).reshape(256, 8),
            "iq2xs": z["iq2xs"].view(np.uint8).reshape(512, 8),
            "iq2s": z["iq2s"].view(np.uint8).reshape(1024, 8),
            "iq3xxs": z["iq3xxs"].view(np.uint8).reshape(256, 4),
            "iq3s": z["iq3s"].view(np.uint8).reshape(512, 4),
            "iq1s": z["iq1s"].view(np.int8).reshape(512, 8),
            # ksigns_iq2xs is derivable: bit 7 makes total parity odd.
            "ksigns": (i | ((pop & 1) << 7).astype(np.uint8)),
        }
    return _IQ


def _sign_expand(sbytes: np.ndarray, width: int = 8) -> np.ndarray:
    """uint8 sign bytes [...] -> f32 signs [..., width] (-1 where the
    bit is set)."""
    bits = (sbytes[..., None] >> np.arange(width, dtype=np.uint8)) & 1
    return np.where(bits != 0, -1.0, 1.0).astype(np.float32)


def decode_iq2_xxs_container(raw: np.ndarray, row_len: int):
    """IQ2_XXS: 8-value grid rows + ksigns + 4-bit sub-scale; G=32."""
    t = _iq_tables()
    rows = raw.shape[0]
    blocks = raw.reshape(rows, -1, 66)
    nsb = blocks.shape[1]
    d = blocks[:, :, 0:2].reshape(rows, -1, 2).copy().view(
        np.float16).astype(np.float32)[:, :, 0]
    qs = blocks[:, :, 2:66].copy().view("<u2").reshape(rows, nsb, 8, 4)
    aux8 = qs[..., 0:2].copy().view(np.uint8)  # [rows, nsb, 8, 4]
    aux32 = qs[..., 2].astype(np.uint32) | (
        qs[..., 3].astype(np.uint32) << 16)
    grid = t["iq2xxs"][aux8]  # [rows, nsb, 8, 4, 8] magnitudes
    sidx = np.stack([(aux32 >> (7 * il)) & 127 for il in range(4)],
                    axis=-1)  # [rows, nsb, 8, 4]
    signs = _sign_expand(t["ksigns"][sidx])  # [rows, nsb, 8, 4, 8]
    q = np.clip(grid.astype(np.float32) * signs, -127,
                127).astype(np.int8)
    q = q.reshape(rows, row_len)
    scale = (d[:, :, None]
             * (0.5 + (aux32 >> 28).astype(np.float32)) * 0.25)
    return q, scale.reshape(rows, -1).astype(np.float32), \
        np.zeros((rows, row_len // 32), np.float32)


def decode_iq2_xs_container(raw: np.ndarray, row_len: int):
    """IQ2_XS: 9-bit grid index | 7-bit sign index, per-16 scales."""
    t = _iq_tables()
    rows = raw.shape[0]
    blocks = raw.reshape(rows, -1, 74)
    nsb = blocks.shape[1]
    d = blocks[:, :, 0:2].reshape(rows, -1, 2).copy().view(
        np.float16).astype(np.float32)[:, :, 0]
    qs = blocks[:, :, 2:66].copy().view("<u2").reshape(rows, nsb, 8, 4)
    sc = blocks[:, :, 66:74]  # [rows, nsb, 8]
    grid = t["iq2xs"][qs & 511]  # [rows, nsb, 8, 4, 8]
    signs = _sign_expand(t["ksigns"][qs >> 9])
    q = np.clip(grid.astype(np.float32) * signs, -127,
                127).astype(np.int8).reshape(rows, row_len)
    # scale nibble: low for il 0-1, high for il 2-3 -> per 16 values.
    lo = (sc & 0xF).astype(np.float32)
    hi = (sc >> 4).astype(np.float32)
    nib = np.stack([lo, hi], axis=-1)  # [rows, nsb, 8, 2]
    scale = d[:, :, None, None] * (0.5 + nib) * 0.25
    return q, scale.reshape(rows, -1).astype(np.float32), \
        np.zeros((rows, row_len // 16), np.float32)


def decode_iq2_s_container(raw: np.ndarray, row_len: int):
    """IQ2_S: 10-bit grid index (qh extends), explicit sign bytes."""
    t = _iq_tables()
    rows = raw.shape[0]
    blocks = raw.reshape(rows, -1, 82)
    nsb = blocks.shape[1]
    d = blocks[:, :, 0:2].reshape(rows, -1, 2).copy().view(
        np.float16).astype(np.float32)[:, :, 0]
    qs = blocks[:, :, 2:34].reshape(rows, nsb, 8, 4)
    sbytes = blocks[:, :, 34:66].reshape(rows, nsb, 8, 4)
    qh = blocks[:, :, 66:74]  # [rows, nsb, 8]
    sc = blocks[:, :, 74:82]
    il = np.arange(4)
    idx = (qs.astype(np.uint32)
           | ((qh[..., None].astype(np.uint32) << (8 - 2 * il))
              & 0x300))
    grid = t["iq2s"][idx]  # [rows, nsb, 8, 4, 8]
    signs = _sign_expand(sbytes)
    q = np.clip(grid.astype(np.float32) * signs, -127,
                127).astype(np.int8).reshape(rows, row_len)
    lo = (sc & 0xF).astype(np.float32)
    hi = (sc >> 4).astype(np.float32)
    nib = np.stack([lo, hi], axis=-1)
    scale = d[:, :, None, None] * (0.5 + nib) * 0.25
    return q, scale.reshape(rows, -1).astype(np.float32), \
        np.zeros((rows, row_len // 16), np.float32)


def decode_iq3_xxs_container(raw: np.ndarray, row_len: int):
    """IQ3_XXS: 4-value grid rows, ksigns, 4-bit sub-scale; G=32."""
    t = _iq_tables()
    rows = raw.shape[0]
    blocks = raw.reshape(rows, -1, 98)
    nsb = blocks.shape[1]
    d = blocks[:, :, 0:2].reshape(rows, -1, 2).copy().view(
        np.float16).astype(np.float32)[:, :, 0]
    qs = blocks[:, :, 2:66].reshape(rows, nsb, 8, 8)  # grid idx bytes
    gas = blocks[:, :, 66:98].copy().view("<u2").reshape(rows, nsb, 8, 2)
    aux32 = gas[..., 0].astype(np.uint32) | (
        gas[..., 1].astype(np.uint32) << 16)
    grid = t["iq3xxs"][qs]  # [rows, nsb, 8, 8, 4]
    sidx = np.stack([(aux32 >> (7 * il)) & 127 for il in range(4)],
                    axis=-1)  # [rows, nsb, 8, 4]
    signs = _sign_expand(t["ksigns"][sidx])  # [rows, nsb, 8, 4, 8]
    # value layout per ib: il-th group of 8 = grid[2il][j] (j 0..3 with
    # sign bits j) then grid[2il+1][j] (sign bits 4+j).
    g = grid.reshape(rows, nsb, 8, 4, 2, 4).astype(np.float32)
    s = signs.reshape(rows, nsb, 8, 4, 2, 4)
    q = np.clip(g * s, -127, 127).astype(np.int8).reshape(rows, row_len)
    scale = (d[:, :, None]
             * (0.5 + (aux32 >> 28).astype(np.float32)) * 0.5)
    return q, scale.reshape(rows, -1).astype(np.float32), \
        np.zeros((rows, row_len // 32), np.float32)


def decode_iq3_s_container(raw: np.ndarray, row_len: int):
    """IQ3_S: 9-bit grid index (qh extends), explicit signs; G=32."""
    t = _iq_tables()
    rows = raw.shape[0]
    blocks = raw.reshape(rows, -1, 110)
    nsb = blocks.shape[1]
    d = blocks[:, :, 0:2].reshape(rows, -1, 2).copy().view(
        np.float16).astype(np.float32)[:, :, 0]
    qs = blocks[:, :, 2:66].reshape(rows, nsb, 8, 8)
    qh = blocks[:, :, 66:74]  # [rows, nsb, 8]
    sbytes = blocks[:, :, 74:106].reshape(rows, nsb, 8, 4)
    sc = blocks[:, :, 106:110]  # [rows, nsb, 4]
    il = np.arange(4)
    idx1 = (qs[..., 0::2].astype(np.uint32)
            | ((qh[..., None].astype(np.uint32) << (8 - 2 * il)) & 256))
    idx2 = (qs[..., 1::2].astype(np.uint32)
            | ((qh[..., None].astype(np.uint32) << (7 - 2 * il)) & 256))
    g1 = t["iq3s"][idx1].astype(np.float32)  # [rows, nsb, 8, 4, 4]
    g2 = t["iq3s"][idx2].astype(np.float32)
    signs = _sign_expand(sbytes)  # [rows, nsb, 8, 4, 8]
    v1 = g1 * signs[..., 0:4]
    v2 = g2 * signs[..., 4:8]
    q = np.clip(np.stack([v1, v2], axis=4), -127, 127).astype(
        np.int8).reshape(rows, row_len)
    # scale nibble per ib: scales[ib/2] >> 4*(ib%2).
    lo = (sc & 0xF).astype(np.float32)
    hi = (sc >> 4).astype(np.float32)
    nib = np.stack([lo, hi], axis=-1).reshape(rows, nsb, 8)
    scale = d[:, :, None] * (0.5 + nib) * 0.5
    return q, scale.reshape(rows, -1).astype(np.float32), \
        np.zeros((rows, row_len // 32), np.float32)


def decode_iq1_s_container(raw: np.ndarray, row_len: int):
    """IQ1_S (LEGACY 512-grid layout): 8-value int8 grid rows, 3-bit
    scale per 8 values; G=8.

    Modern llama.cpp IQ1_S files (Mar 2024+) switched to a
    2048-entry grid + IQ1S_DELTA superblock-sign format with the SAME
    type id and 50-byte block, and the two layouts cannot be told
    apart from the tensor bytes. We only carry the 512-entry lattice
    (the one the reference's vendored ggml tables define), so decoding
    a modern file here would silently produce garbage weights. Refuse
    by default; APHRODITE_GGUF_IQ1S_LEGACY=1 asserts the file really
    is legacy-layout and re-enables this decoder."""
    import os
    if os.environ.get("APHRODITE_GGUF_IQ1S_LEGACY", "0") != "1":
        raise ValueError(
            "IQ1_S: only the legacy 512-grid layout is supported, and "
            "modern llama.cpp IQ1_S files (2048-grid + delta, same "
            "type id and block size) are indistinguishable from it. "
            "If this file predates the format change, set "
            "APHRODITE_GGUF_IQ1S_LEGACY=1 to decode it; otherwise "
            "requantize to IQ1_M/IQ2_XXS or a k-quant.")
    t = _iq_tables()
    rows = raw.shape[0]
    blocks = raw.reshape(rows, -1, 50)
    nsb = blocks.shape[1]
    d = blocks[:, :, 0:2].reshape(rows, -1, 2).copy().view(
        np.float16).astype(np.float32)[:, :, 0]
    qs = blocks[:, :, 2:34]  # [rows, nsb, 32]
    scb = blocks[:, :, 34:50]  # [rows, nsb, 16] nibble pairs
    h = np.stack([scb & 0xF, scb >> 4], axis=-1).reshape(rows, nsb, 32)
    idx = qs.astype(np.uint32) | ((h.astype(np.uint32) & 8) << 5)
    q = t["iq1s"][idx].reshape(rows, row_len)  # int8 grid values
    scale = d[:, :, None] * (2.0 * (h & 7).astype(np.float32) + 1.0)
    return q, scale.reshape(rows, -1).astype(np.float32), \
        np.zeros((rows, row_len // 8), np.float32)


# ggml type -> container decoder for natively-servable quants
# (everything here maps losslessly onto the grouped (q - zero) * scale
# container consumed by the fused dequant-matmul kernels; reference
# serves the same set through its CUDA mmvq/mmq kernels,
# kernels/quantization/gguf/*.cu).
_CONTAINER_DECODERS = {
    GGML_Q4_0: decode_q4_0_container,
    GGML_Q4_1: decode_q4_1_container,
    GGML_Q4_K: decode_q4_k_container,
    GGML_Q5_0: decode_q5_0_container,
    GGML_Q5_1: decode_q5_1_container,
    GGML_Q8_0: decode_q8_0_container,
    GGML_Q2_K: decode_q2_k_container,
    GGML_Q3_K: decode_q3_k_container,
    GGML_Q5_K: decode_q5_k_container,
    GGML_Q6_K: decode_q6_k_container,
    GGML_IQ4_NL: decode_iq4_nl_container,
    GGML_IQ4_XS: decode_iq4_xs_container,
    GGML_IQ2_XXS: decode_iq2_xxs_container,
    GGML_IQ2_XS: decode_iq2_xs_container,
    GGML_IQ2_S: decode_iq2_s_container,
    GGML_IQ3_XXS: decode_iq3_xxs_container,
    GGML_IQ3_S: decode_iq3_s_container,
    GGML_IQ1_S: decode_iq1_s_container,
}


def dequant_tensor(gg: GGUFFile, info: GGUFTensorInfo) -> np.ndarray:
    """Full-precision [out, in] float32 for any supported tensor type."""
    row_len = info.dims[0]
    raw = gg.raw_blocks(info)
    t = info.ggml_type
    if t == GGML_F32:
        out = decode_f32(raw, row_len)
    elif t == GGML_F16:
        out = decode_f16(raw, row_len)
    elif t == GGML_BF16:
        out = decode_bf16(raw, row_len)
    elif t in _CONTAINER_DECODERS:
        q, scale, zero = _CONTAINER_DECODERS[t](raw, row_len)
        G = row_len // scale.shape[1]
        s = np.repeat(scale, G, axis=1)
        z = np.repeat(zero, G, axis=1)
        out = (q.astype(np.float32) - z) * s
    else:
        raise ValueError(
            f"GGUF tensor type {t} ({info.name}) not supported "
            "(of the ggml quant families only IQ1_M is unimplemented)")
    shape = list(reversed(info.dims))
    return out.reshape(shape)


def to_int4_pieces(gg: GGUFFile, info: GGUFTensorInfo):
    """(q [rows,row_len], scale [rows,row_len/G], zero) for any
    container-servable type (q4/q5/q6/q8/q2_k/q3_k/iq4 families)."""
    row_len = info.dims[0]
    raw = gg.raw_blocks(info)
    dec = _CONTAINER_DECODERS.get(info.ggml_type)
    if dec is None:
        raise ValueError(f"not container-servable: {info.ggml_type}")
    return dec(raw, row_len)


# ---------------------------------------------------------------------------
# Model integration
# ---------------------------------------------------------------------------

# GGUF tensor name -> our param path (llama-family archs).
_GGUF_LAYER_MAP = {
    "blk.{i}.attn_norm.weight": "layers.input_norm",
    "blk.{i}.attn_q.weight": "layers.wq",
    "blk.{i}.attn_k.weight": "layers.wk",
    "blk.{i}.attn_v.weight": "layers.wv",
    "blk.{i}.attn_output.weight": "layers.wo",
    "blk.{i}.ffn_norm.weight": "layers.post_norm",
    "blk.{i}.ffn_gate.weight": "layers.gate",
    "blk.{i}.ffn_up.weight": "layers.up",
    "blk.{i}.ffn_down.weight": "layers.down",
    "blk.{i}.attn_q.bias": "layers.bq",
    "blk.{i}.attn_k.bias": "layers.bk",
    "blk.{i}.attn_v.bias": "layers.bv",
}
_GGUF_GLOBAL_MAP = {
    "token_embd.weight": "embed",
    "output_norm.weight": "final_norm",
    "output.weight": "lm_head",
}

_ARCH_TO_HF = {
    "llama": "LlamaForCausalLM",
    "mistral": "MistralForCausalLM",
    "qwen2": "Qwen2ForCausalLM",
    "gemma": "GemmaForCausalLM",
    "gemma2": "Gemma2ForCausalLM",
    "phi3": "Phi3ForCausalLM",
}
# llama.cpp architecture names (``general.architecture``) of the families
# whose GGUF tensors the port does not map, each with the ROADMAP item that
# holds it: every family the port serves or lists as waiting whose file
# the Llama mapping above would load wrongly (other norms, fused or
# partial q|k|v, biases, plain MLPs, learned positions, experts, SSM
# state). The JAX package's gguf_to_hf_config serves every unknown name
# as Llama; here such a file raises by name before anything is built.
_DENSE_GGUF = "item 3, GGUF files of the dense families"
_UNPORTED_GGUF_ARCHS = {
    **dict.fromkeys((
        "gemma", "gemma2", "gemma3", "phi3", "falcon", "bloom", "mpt",
        "jais", "gptneox", "phi2", "stablelm", "gptj", "persimmon",
        "command-r", "cohere2", "nemotron", "chatglm", "glm4", "gpt2",
        "starcoder", "starcoder2", "granite", "olmo", "olmo2", "orion",
        "internlm2", "exaone", "deci", "baichuan", "qwen", "qwen3",
        "minicpm", "minicpm3", "t5", "t5encoder"), _DENSE_GGUF),
    **dict.fromkeys((
        "qwen2moe", "qwen3moe", "olmoe", "phimoe", "granitemoe", "dbrx",
        "arctic", "deepseek", "deepseek2"),
        "item 7, quantized MoE checkpoints"),
    **dict.fromkeys(("mamba", "mamba2", "jamba"), "item 10, the SSMs"),
}


def refuse_unported_arch(arch: str) -> None:
    """Raise, naming the ROADMAP item, for a GGUF architecture whose
    tensors the port does not map."""
    if arch in _UNPORTED_GGUF_ARCHS:
        raise NotImplementedError(
            f"GGUF files of architecture {arch!r} are not ported yet "
            f"(ROADMAP.md, module queue {_UNPORTED_GGUF_ARCHS[arch]}); "
            "load the HF checkpoint")


def gguf_to_hf_config(path: str) -> Dict[str, Any]:
    """Synthesize an HF-style config dict from GGUF metadata (reference
    transformers_utils config extraction for gguf)."""
    gg = GGUFFile(path)
    md = gg.metadata
    arch = md.get("general.architecture", "llama")
    refuse_unported_arch(arch)

    def g(key, default=None):
        return md.get(f"{arch}.{key}", default)

    heads = int(g("attention.head_count", 32))
    embd = int(g("embedding_length", 4096))
    vocab = gg.tensors["token_embd.weight"].dims[1] if \
        "token_embd.weight" in gg.tensors else len(
            md.get("tokenizer.ggml.tokens", []) or [32000])
    cfg = {
        "architectures": [_ARCH_TO_HF.get(arch, "LlamaForCausalLM")],
        "hidden_size": embd,
        "intermediate_size": int(g("feed_forward_length", 11008)),
        "num_hidden_layers": int(g("block_count", 32)),
        "num_attention_heads": heads,
        "num_key_value_heads": int(g("attention.head_count_kv", heads)),
        "max_position_embeddings": int(g("context_length", 2048)),
        "rms_norm_eps": float(g("attention.layer_norm_rms_epsilon", 1e-5)),
        "rope_theta": float(g("rope.freq_base", 10000.0)),
        "vocab_size": int(vocab),
        "torch_dtype": "bfloat16",
        "tie_word_embeddings": "output.weight" not in gg.tensors,
    }
    head_dim = g("attention.key_length")
    if head_dim:
        cfg["head_dim"] = int(head_dim)
    return cfg


def _transposed(a: np.ndarray) -> np.ndarray:
    """a.T as a contiguous array (the same bytes), copied by torch's
    blocked, multi-threaded transpose: numpy's walks one core across a
    large matrix's rows, the longest part of a GGUF load at 8B widths."""
    return torch.from_numpy(a).t().contiguous().numpy()


def _stack_layers(our_path: str, layer_list: List[Any]):
    """Per-layer pieces on a leading [L] axis: arrays, or containers member
    by member."""
    if not any(isinstance(p, dict) for p in layer_list):
        return torch.from_numpy(np.stack(layer_list, axis=0))
    kinds = {frozenset(p) if isinstance(p, dict) else "dense"
             for p in layer_list}
    if len(kinds) > 1:
        raise ValueError(
            f"gguf layers of {our_path} mix weight kinds "
            f"{sorted(sorted(k) if k != 'dense' else [k] for k in kinds)}: "
            "a layer-stacked weight needs one kind (all dense, all packed "
            "q4p, or all one level per byte) in every layer")
    return {k: torch.from_numpy(np.stack([c[k] for c in layer_list], axis=0))
            for k in layer_list[0]}


def load_gguf_params_to_host(model, path: str) -> Dict[str, Any]:
    """Assemble the host params tree (CPU tensors) from a GGUF file. The
    model's quantizable weights stay quantized where their block type
    maps onto a container; everything else dequantizes to float32 (cast
    to the model dtype at placement)."""
    from aphrodite_tpu_torch.loader.weights import _set_path
    from aphrodite_tpu_torch.quantization.int4 import maybe_pack

    gg = GGUFFile(path)
    refuse_unported_arch(gg.metadata.get("general.architecture", "llama"))
    num_layers = model.num_layers
    quantizable = set(model.quantizable_weights())

    name_map: Dict[str, Tuple[str, Optional[int]]] = {}
    for template, our_path in _GGUF_LAYER_MAP.items():
        for i in range(num_layers):
            name_map[template.format(i=i)] = (our_path, i)
    for name, our_path in _GGUF_GLOBAL_MAP.items():
        name_map[name] = (our_path, None)

    pieces: Dict[str, List[Optional[Any]]] = {}
    params: Dict[str, Any] = {}
    for name, info in gg.tensors.items():
        target = name_map.get(name)
        if target is None:
            logger.debug("skipping unmapped gguf tensor %s", name)
            continue
        our_path, layer_idx = target
        servable = info.ggml_type in _CONTAINER_DECODERS
        if our_path in quantizable and servable:
            q, scale, zero = to_int4_pieces(gg, info)
            # ggml rows = out features; our layout is [in, out].
            # maybe_pack nibble-packs only when the levels fit [0, 15]
            # (q4 family, q2_k, q3_k); q5/q6/q8/iq levels keep one byte
            # each.
            piece = maybe_pack({"q4": _transposed(q),
                                "scale": _transposed(scale),
                                "zero": _transposed(zero)})
        else:
            arr = dequant_tensor(gg, info)  # [out, in] or [n]
            if arr.ndim == 2 and our_path not in ("embed",):
                arr = _transposed(arr)
            piece = arr
        if layer_idx is None:
            _set_path(params, our_path,
                      {k: torch.from_numpy(v) for k, v in piece.items()}
                      if isinstance(piece, dict)
                      else torch.from_numpy(np.array(piece)))
        else:
            pieces.setdefault(our_path, [None] * num_layers)
            pieces[our_path][layer_idx] = piece

    for our_path, layer_list in pieces.items():
        missing = [i for i, a in enumerate(layer_list) if a is None]
        if missing:
            raise ValueError(f"gguf missing layers {missing[:4]} for "
                             f"{our_path}")
        _set_path(params, our_path, _stack_layers(our_path, layer_list))
    return params
