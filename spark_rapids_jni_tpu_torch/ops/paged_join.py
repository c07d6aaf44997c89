"""The paged hash table of the single-key equi-join (port of the JAX
package's ``build_paged_table``, ``ops/pallas_kernels.py:530-663``).

BUILD: bucket = fmix(order word) & (B - 1); build rows sort by (bucket,
key, row) with two stable argsorts and fill fixed 128-slot pages
allocated contiguously per bucket, so bucket b's overflow chain is pages
``page_first[b] .. page_first[b] + chain_len[b]``. Within a bucket the
slots are (key, row)-sorted, so a probe's matches are one contiguous
range of build ranks. Everything that decides which build rows a probe
returns, and in what order, is kept bit for bit: the bucket count loop,
the order words, the bucket function, the two stable argsorts, nulls
parked at bucket B, ``meta``'s packing, ``r_order``, ``n_pages``,
``c_max`` (a power of two), ``nm`` and the ``None`` gates.

The slot contents are the port's own. The reference stores u8 limbs of
the order words in bf16 planes, with an "empty" sentinel of 320, because
the TPU gathers a page with one-hot matrix products. Here a slot holds
the order word itself (int32 bits for keys of 4 bytes or fewer, int64
bits for 8-byte keys), and ``counts[b]`` records how many of bucket b's
slots are occupied, since a 64-bit word has no value left for a sentinel.

The caps stay as the reference has them, so that the same inputs take
the same route in both packages. The 2,048-page cap is the TPU's VMEM
limit for the limb planes; the card keeps the whole table (at most
2,048 x 128 x 8 B = 2 MiB) in L2, and a later change may lift it.

The table also carries its fences for the probe kernel (B4,
``hopper_kernels.probe_paged``): every S-th slot, ``slots[::S]`` (one
strided copy), with each bucket's first fence, ``fence_first[b] =
page_first[b] * 128 / S``. Each block of the kernel keeps every bucket's
metadata and the fences in shared memory, finds a probe's segment of S
slots there and loads only that segment. S (``fence_stride``) is the
smallest of 4, 8 and 16 whose segment is at least one 32-byte sector and
whose fences fit ``MAX_FENCE_BYTES``: 8 for int32 words (64 KB at the
join path's 1,024 pages); for int64 words 4 up to 512 pages, 8 up to
1,024 and 16 past them. The plain probe ignores the fences.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .bitutils import SIGN64
from .murmur import fmix
from .uword import split_u64, u32_to_i64

__all__ = [
    "PAGE",
    "MAX_BUILD",
    "MAX_PAGES",
    "MAX_FENCE_BYTES",
    "PagedHashTable",
    "key_words",
    "order_words",
    "unpack_meta",
    "compare_form",
    "bucket_of",
    "fence_stride",
    "build_paged_table",
]

PAGE = 128  # slots per page
MAX_BUILD = 1 << 16  # build rows the page table will hold
MAX_PAGES = 2048  # the reference's VMEM cap
_BUCKET_TARGET = 64  # average build rows per bucket
_MAX_BUCKETS = 2048
MAX_FENCE_BYTES = 128 * 1024  # the fences' share of a probe block's shared memory
_FENCE_STRIDES = (4, 8, 16)  # the strides the probe kernel takes (csrc/join.cu)
_SEGMENT_BYTES = 32  # the least segment: a sector (a smaller one costs shared memory, no loads)

_UNSIGNED = (torch.uint8, torch.uint16, torch.uint32, torch.uint64)


class PagedHashTable(NamedTuple):
    """Build-side page table (see the module docstring)."""

    slots: torch.Tensor  # [n_pages * 128] order words, bucket b from page_first[b] * 128
    counts: torch.Tensor  # [B] int32: occupied slots of each bucket
    meta: torch.Tensor  # [B] int64: page_first << 44 | chain_len << 24 | slot_start
    r_order: torch.Tensor  # [nm] int32: page-sorted rank -> original build row
    num_buckets: int
    n_pages: int
    nlimb: int  # the reference's limb count: 4 for 32-bit order words, 8 for 64-bit
    c_max: int  # longest overflow chain, rounded up to a power of two
    nm: int  # matchable (non-null) build rows
    # the probe kernel's fences: bucket b's slot j * fence_stride is
    # fences[fence_first[b] + j]
    fences: Optional[torch.Tensor] = None  # [n_pages * 128 / fence_stride]: slots[::fence_stride]
    fence_first: Optional[torch.Tensor] = None  # [B] int32: page_first * 128 / fence_stride
    fence_stride: int = 0


def _pow2_ceil(v: int) -> int:
    p = 1
    while p < v:
        p *= 2
    return p


def key_words(keys: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    """[N] integer keys -> (words, flip): the keys' bits as int32 (keys of
    4 bytes or fewer, narrower ones widened by their type's extension) or
    int64 (8-byte keys), and whether the order word flips the sign bit
    (signed keys). Signedness comes from the torch type: the port stores
    UINT16/32/64 in signed lanes, so pass those as
    ``data.view(torch.uint16)`` (``uint32``, ``uint64``)."""
    if keys.dtype.is_floating_point or keys.dtype == torch.bool:
        raise ValueError(f"paged join keys must be integers, got {keys.dtype}")
    signed = keys.dtype not in _UNSIGNED
    if keys.dtype == torch.int32 or keys.dtype == torch.int64:
        return keys, signed
    if keys.element_size() == 8:
        return keys.view(torch.int64), signed
    if keys.element_size() == 4:
        return keys.view(torch.int32), signed
    return keys.to(torch.int32), signed  # sign- or zero-extends by the torch type


def order_words(keys: torch.Tensor) -> torch.Tensor:
    """[N] integer keys -> order-preserving unsigned words (the
    reference's ``_order_map_u``): int32 bits of a u32 word for keys of 4
    bytes or fewer, int64 bits of a u64 word for 8-byte keys. An unsigned
    compare of the words agrees with the keys' order."""
    words, flip = key_words(keys)
    if not flip:
        return words
    return words ^ (SIGN64 if words.dtype == torch.int64 else torch.iinfo(torch.int32).min)


def compare_form(u: torch.Tensor) -> torch.Tensor:
    """Order words -> int64 values whose signed order is the words'
    unsigned order (a u32 word zero-extended; a u64 word with its sign
    bit flipped)."""
    if u.dtype == torch.int64:
        return u ^ SIGN64
    return u32_to_i64(u)


def bucket_of(u: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """[N] order words -> [N] int64 bucket ids in [0, B): fmix of the
    word, or of lo ^ fmix(hi) for a 64-bit word, masked to B - 1."""
    if u.dtype == torch.int64:
        lo, hi = split_u64(u)
        h = fmix(u32_to_i64(lo) ^ fmix(u32_to_i64(hi)))
    else:
        h = fmix(u32_to_i64(u))
    return h & (num_buckets - 1)


def fence_stride(n_pages: int, word_bytes: int) -> int:
    """The probe's fence stride for a table of ``n_pages`` pages of
    ``word_bytes``-byte order words: the smallest of ``_FENCE_STRIDES``
    whose segment (S words) is at least ``_SEGMENT_BYTES`` and whose
    fences (``n_pages * 128 / S`` words) fit ``MAX_FENCE_BYTES``. At the
    last stride every table within the page cap fits (2,048 pages of
    int64 words: 128 KB); past it, ValueError."""
    for s in _FENCE_STRIDES:
        if s * word_bytes >= _SEGMENT_BYTES and n_pages * PAGE // s * word_bytes <= MAX_FENCE_BYTES:
            return s
    raise ValueError(f"the fences of {n_pages} pages of {word_bytes}-byte words do not fit "
                     f"{MAX_FENCE_BYTES} B")


def build_paged_table(
    keys: torch.Tensor, valid: Optional[torch.Tensor] = None
) -> Optional[PagedHashTable]:
    """Partition build-side keys into 128-slot pages with contiguous
    overflow chaining. Returns None when the build side is empty,
    all-null, or over the caps (more than 65,536 rows or 2,048 pages):
    the join then takes its sort-probe formulation. One host sync, for
    the matchable rows, the page count and the longest chain."""
    n = int(keys.shape[0])
    if n == 0 or n > MAX_BUILD:
        return None
    dev = keys.device
    u = order_words(keys)
    nlimb = 8 if u.dtype == torch.int64 else 4
    # sized by n (nm is still on the device here): at most one doubling
    # too many when the build side is null-heavy
    num_buckets = 16
    while num_buckets * _BUCKET_TARGET < n and num_buckets < _MAX_BUCKETS:
        num_buckets *= 2
    bucket = bucket_of(u, num_buckets)
    if valid is not None:
        # null build keys never match: park them past the last bucket
        bucket = torch.where(valid, bucket, num_buckets)
    # (bucket, key, row) order from two stable argsorts: by key first,
    # then stably by bucket, so equal (bucket, key) keep build-row order
    perm1 = torch.argsort(compare_form(u), stable=True)
    perm = perm1[torch.argsort(bucket[perm1], stable=True)]
    bs_full = bucket[perm]  # the parked nulls sort last

    bids = torch.arange(num_buckets, dtype=torch.int64, device=dev)
    starts = torch.searchsorted(bs_full, bids, side="left")
    cnt = torch.searchsorted(bs_full, bids, side="right") - starts
    pages_b = (cnt + PAGE - 1) // PAGE
    page_first = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                            torch.cumsum(pages_b, 0)])
    nm_dev = torch.tensor(n, device=dev) if valid is None else valid.sum()
    nm, n_pages, c_max = torch.stack([nm_dev.to(torch.int64), page_first[-1],
                                      pages_b.max()]).tolist()
    if nm == 0 or n_pages == 0 or n_pages > MAX_PAGES:
        return None
    r_order = perm[:nm]
    bs = bs_full[:nm]
    rank = torch.arange(nm, dtype=torch.int64, device=dev) - starts[bs]
    slots = torch.zeros(n_pages * PAGE, dtype=u.dtype, device=dev)
    slots[page_first[bs] * PAGE + rank] = u[r_order]
    meta = (page_first[:num_buckets] << 44) | (pages_b << 24) | starts
    # the fences as the probe kernel reads them: a fresh contiguous copy
    # (16-byte aligned, as every allocation), n_pages * 128 / S words of
    # whole 16-byte vectors
    stride = fence_stride(n_pages, slots.element_size())
    fence_first = (page_first[:num_buckets] * (PAGE // stride)).to(torch.int32)
    return PagedHashTable(slots, cnt.to(torch.int32), meta, r_order.to(torch.int32), num_buckets,
                          n_pages, nlimb, _pow2_ceil(max(c_max, 1)), nm,
                          slots[::stride].contiguous(), fence_first, stride)


def unpack_meta(meta: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """meta -> (page_first, chain_len, slot_start), int64 each."""
    return meta >> 44, (meta >> 24) & 0xFFFFF, meta & 0xFFFFFF
