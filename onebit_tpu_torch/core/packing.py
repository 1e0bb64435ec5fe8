"""Sign-bit packing for OneBit weights, in PyTorch and numpy.

Bit convention (byte-compatible with the reference packer and unpacker):

* bit value ``b = (1 - s) / 2`` (sign ``+1 -> 0``, ``-1 -> 1``);
* LSB-first: element ``i`` of a row lands in word ``i // 32`` at bit
  ``i % 32`` (canonical int32 words), or in byte ``i // 8`` at bit ``i % 8``
  (the reference int8 checkpoint format). An int32 word is exactly four
  consecutive reference bytes read little-endian.

Three layouts appear here:

* **canonical** ``[..., out, in//32]`` int32: the reference int8 checkpoint
  viewed as int32 (:func:`pack_signs`, :func:`int8_bytes_to_words_np`);
* **TPU device layout** ``[..., in//32, out]`` int32, the JAX package's
  byte-plane layout: dense in-index ``k = p*4*nw + 4*i + c`` (``nw = in//32``)
  lives in word row ``i`` at bit ``8*c + p``. It exists to invert a TPU
  bitcast order; :func:`unpack_signs_device` reads it,
  :func:`device_to_kmajor` converts it and :func:`kmajor_to_device` writes
  it back (native checkpoints keep it on disk);
* **the port's layout** ``[..., in//32, out]`` int32, *K-major canonical*:
  word ``(i, n)`` holds in-indices ``32*i .. 32*i+31`` of output column ``n``,
  LSB-first. It is the canonical words transposed, so a reference int8
  checkpoint loads with one transpose. The CUDA kernels read it with each
  thread of a warp on a neighbouring output column, so every load of a word
  row is coalesced, and bit ``j`` of a word is the sign of ``k = 32*i + j``.

torch's ``>>`` on int32 is an arithmetic shift: every shift here is
followed by a mask. Words are built in int64 and wrapped to int32.
"""

from __future__ import annotations

import numpy as np
import torch

WORD_BITS = 32
_BYTE_BITS = 8


def _wrap_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in ``[0, 2**32)`` -> the int32 with the same bits."""
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def _bit_shifts(device) -> torch.Tensor:
    return torch.arange(WORD_BITS, dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# Canonical int32 words
# ---------------------------------------------------------------------------

def pack_signs(w: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Pack signs of ``w`` along ``axis`` into int32 words (32 per word).

    ``w >= 0`` packs as bit 0 (sign +1), ``w < 0`` as bit 1 (sign -1).
    """
    w = torch.as_tensor(w)
    w = w.movedim(axis, -1)
    n = w.shape[-1]
    if n % WORD_BITS != 0:
        raise ValueError(f"packed axis length {n} not a multiple of {WORD_BITS}")
    bits = (w < 0).to(torch.int64).reshape(*w.shape[:-1], n // WORD_BITS,
                                          WORD_BITS)
    shifts = torch.arange(WORD_BITS, dtype=torch.int64, device=w.device)
    words = _wrap_int32((bits << shifts).sum(-1))
    return words.movedim(-1, axis)


def unpack_signs(words: torch.Tensor, dtype=torch.bfloat16,
                 axis: int = -1) -> torch.Tensor:
    """Unpack int32 sign words back to a dense ±1 tensor along ``axis``."""
    words = torch.as_tensor(words).movedim(axis, -1)
    bits = (words[..., None] >> _bit_shifts(words.device)) & 1
    bits = bits.reshape(*words.shape[:-1], words.shape[-1] * WORD_BITS)
    return (1 - 2 * bits).to(dtype).movedim(-1, axis)


# ---------------------------------------------------------------------------
# Reference int8 format (8 signs per byte), numpy
# ---------------------------------------------------------------------------

def pack_signs_int8_np(w: np.ndarray) -> np.ndarray:
    """Pack signs into the reference int8 byte format (last axis)."""
    w = np.asarray(w)
    n = w.shape[-1]
    if n % _BYTE_BITS != 0:
        raise ValueError(f"last axis {n} not a multiple of 8")
    bits = (w < 0).astype(np.uint8).reshape(*w.shape[:-1], n // _BYTE_BITS,
                                            _BYTE_BITS)
    mult = (1 << np.arange(_BYTE_BITS, dtype=np.uint8)).astype(np.uint8)
    return (bits * mult).sum(-1).astype(np.uint8).view(np.int8)


def unpack_signs_int8_np(packed: np.ndarray, dtype=np.float32) -> np.ndarray:
    """Unpack the reference int8 byte format to dense ±1."""
    u = np.asarray(packed).view(np.uint8)
    shifts = np.arange(_BYTE_BITS, dtype=np.uint8)
    bits = (u[..., None] >> shifts) & np.uint8(1)
    bits = bits.reshape(*u.shape[:-1], u.shape[-1] * _BYTE_BITS)
    return (1 - 2 * bits.astype(np.int8)).astype(dtype)


def int8_bytes_to_words_np(packed_int8: np.ndarray) -> np.ndarray:
    """Reinterpret reference int8 packed rows as canonical int32 words."""
    a = np.ascontiguousarray(packed_int8)
    if a.shape[-1] % 4 != 0:
        raise ValueError("byte axis must be a multiple of 4 to view as int32")
    return a.view(np.dtype("<i4")).reshape(*a.shape[:-1], a.shape[-1] // 4)


# ---------------------------------------------------------------------------
# TPU device layout
# ---------------------------------------------------------------------------

def _device_bits(words: torch.Tensor) -> torch.Tensor:
    """TPU-layout words ``[..., nw, out]`` -> bits ``[..., in, out]`` (int32)."""
    *lead, nw, n_out = words.shape
    p = torch.arange(8, dtype=torch.int32, device=words.device)
    c = torch.arange(4, dtype=torch.int32, device=words.device)
    shifts = (8 * c[None, :] + p[:, None])[:, None, :, None]   # [8, 1, 4, 1]
    bits = (words[..., None, :, None, :] >> shifts) & 1       # [.., 8, nw, 4, out]
    return bits.reshape(*lead, nw * WORD_BITS, n_out)         # k = p*4nw + 4i + c


def unpack_signs_device(words: torch.Tensor, dtype=torch.bfloat16
                        ) -> torch.Tensor:
    """Read the TPU device layout ``[..., in//32, out]`` -> dense ±1
    ``[..., out, in]``."""
    bits = _device_bits(torch.as_tensor(words))
    return (1 - 2 * bits).to(dtype).transpose(-1, -2)


# ---------------------------------------------------------------------------
# The port's layout: K-major canonical words [..., in//32, out]
# ---------------------------------------------------------------------------

def pack_signs_kmajor(w: torch.Tensor) -> torch.Tensor:
    """Pack ``w [..., out, in]`` into the port's layout ``[..., in//32, out]``."""
    return pack_signs(w, axis=-1).transpose(-1, -2).contiguous()


def unpack_signs_kmajor(words: torch.Tensor, dtype=torch.bfloat16
                        ) -> torch.Tensor:
    """The port's layout ``[..., in//32, out]`` -> dense ±1 ``[..., out, in]``."""
    return unpack_signs(torch.as_tensor(words), dtype=dtype, axis=-2
                        ).transpose(-1, -2)


def device_to_kmajor(words: torch.Tensor) -> torch.Tensor:
    """Convert TPU-layout words ``[nw, out]`` to the port's layout, on the
    tensor's own device. A pure bit permutation: exact."""
    words = torch.as_tensor(words)
    if words.dtype != torch.int32:
        raise TypeError(f"packed words must be int32, got {words.dtype}")
    bits = _device_bits(words)                                # [K, out]
    nw = words.shape[-2]
    bits = bits.reshape(*bits.shape[:-2], nw, WORD_BITS, bits.shape[-1])
    acc = torch.zeros(bits[..., 0, :].shape, dtype=torch.int64,
                      device=words.device)
    for j in range(WORD_BITS):
        acc |= bits[..., j, :].to(torch.int64) << j
    return _wrap_int32(acc)


def kmajor_to_device(words: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`device_to_kmajor`: the port's layout
    ``[..., nw, out]`` -> TPU-layout words, on the tensor's own device.
    Dense in-index ``k = p*4*nw + 4*i + c`` goes to word row ``i`` at bit
    ``8*c + p``. A pure bit permutation: exact."""
    words = torch.as_tensor(words)
    if words.dtype != torch.int32:
        raise TypeError(f"packed words must be int32, got {words.dtype}")
    *lead, nw, n_out = words.shape
    bits = (words[..., :, None, :] >> _bit_shifts(words.device)[:, None]) & 1
    bits = bits.reshape(*lead, 8, nw, 4, n_out)       # k = p*4nw + 4i + c
    acc = torch.zeros(words.shape, dtype=torch.int64, device=words.device)
    for p in range(8):
        for c in range(4):
            acc |= bits[..., p, :, c, :].to(torch.int64) << (8 * c + p)
    return _wrap_int32(acc)
