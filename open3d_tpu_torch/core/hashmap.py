"""Device hash map for integer block coordinates (port of
open3d_tpu/core/hashmap.py).

The table is one (capacity, 2) int32 tensor of packed key pairs, managed
with gathers and scatters only, bit-identical to the JAX package's:

- block coords pack into two int32 words, 21 bits per axis:
  w0 = x21 << 11 | y21_hi11, w1 = y21_lo10 << 22 | z21 << 1 | 1;
  w1 == 0 is an empty slot, w1 == 2 a tombstone, odd w1 a live key;
- `find` is a linear probe over at most `max_probes` slots;
- `activate` inserts with a scatter-min claim per round instead of CAS:
  the lowest pending id wins each contested free slot.

The algorithm is deterministic, so tables, slots and `ok` equal the JAX
package's exactly. The uint32 arithmetic of the hash is done in int64 and
masked to 32 bits. The probe and claim loops stop early once every lane is
resolved; the remaining rounds of the JAX loop change nothing. Each test of
that exit is one host read (sites `hash.find` and `hash.claim` of
utils/timer.py's `host_read`), each round past it one count in
`hash.probe_rounds` or `hash.claim_rounds`, and the two functions are the
spans `hash.find` and `hash.activate`.
"""

from __future__ import annotations

import torch

from open3d_tpu_torch.core.platform import default_device
from open3d_tpu_torch.utils.timer import count, host_read, span

KEY_WORDS = 2

_COORD_BITS = 21
_COORD_OFF = 1 << (_COORD_BITS - 1)  # 2^20
_COORD_MASK = (1 << _COORD_BITS) - 1
_U32 = 0xFFFFFFFF

_EMPTY_W1 = 0
_TOMB_W1 = 2


def make_table(capacity: int, device=None) -> torch.Tensor:
    """Fresh table of `capacity` empty slots, on the card unless `device`
    names another (default_device)."""
    return torch.zeros((capacity, 2), dtype=torch.int32, device=default_device(device))


def empty_keys(shape, device=None) -> torch.Tensor:
    """(*shape, 2) invalid keys, on the card unless `device` names another."""
    if isinstance(shape, int):
        shape = (shape,)
    return torch.zeros(tuple(shape) + (2,), dtype=torch.int32, device=default_device(device))


def is_valid(keys: torch.Tensor) -> torch.Tensor:
    """(..., 2) -> (...,) bool: valid packed key (w1 odd)."""
    return (keys[..., 1] & 1) == 1


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bits -> their uint32 value in int64."""
    return x.to(torch.int64) & _U32


def _i32(x: torch.Tensor) -> torch.Tensor:
    """uint32 value held in int64 -> the int32 with the same bits."""
    x = x & _U32
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for a in [0, 2^32), without int64 overflow."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def pack_coords(coords: torch.Tensor) -> torch.Tensor:
    """(..., 3) int32 coords in [-2^20, 2^20-1] -> (..., 2) packed key pair.
    Out-of-range coords are clamped."""
    c = torch.clamp(coords.to(torch.int64) + _COORD_OFF, 0, _COORD_MASK)
    x, y, z = c[..., 0], c[..., 1], c[..., 2]
    w0 = (x << 11) | (y >> 10)
    w1 = ((y & 0x3FF) << 22) | (z << 1) | 1
    return torch.stack([_i32(w0), _i32(w1)], dim=-1)


def unpack_coords(keys: torch.Tensor) -> torch.Tensor:
    """(..., 2) packed -> (..., 3) int32 coords."""
    w0 = _u32(keys[..., 0])
    w1 = _u32(keys[..., 1])
    x = (w0 >> 11) & _COORD_MASK
    y = ((w0 & 0x7FF) << 10) | ((w1 >> 22) & 0x3FF)
    z = (w1 >> 1) & _COORD_MASK
    return (torch.stack([x, y, z], dim=-1) - _COORD_OFF).to(torch.int32)


def _hash(keys: torch.Tensor) -> torch.Tensor:
    """(..., 2) -> (...,) uint32 value in int64: murmur3 fmix32 of the pair."""
    x = _u32(keys[..., 0]) ^ _mul32(_u32(keys[..., 1]), 0x9E3779B1)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def _home(keys: torch.Tensor, C: int) -> torch.Tensor:
    return _hash(keys) % C  # int64 in [0, C)


def find(table: torch.Tensor, query: torch.Tensor, max_probes: int = 32):
    """Look up packed key pairs (N, 2). Returns (slot (N,) int32, found (N,)
    bool); slot is valid only where found."""
    with span("hash.find"):
        C = table.shape[0]
        h = _home(query, C)
        q0, q1 = query[..., 0], query[..., 1]
        valid_q = is_valid(query)
        slot = torch.full(q0.shape, -1, dtype=torch.int64, device=query.device)
        found = torch.zeros(q0.shape, dtype=torch.bool, device=query.device)
        dead = ~valid_q
        for p in range(max_probes):
            if host_read("hash.find", (found | dead).all()):
                break
            count("hash.probe_rounds")
            s = (h + p) % C
            cur = table[s]
            hit = (cur[..., 0] == q0) & (cur[..., 1] == q1) & ~found & ~dead
            slot = torch.where(hit, s, slot)
            found = found | hit
            dead = dead | (cur[..., 1] == _EMPTY_W1)  # empty ends the chain
        return slot.to(torch.int32), found & valid_q


def activate(
    table: torch.Tensor,
    keys: torch.Tensor,
    max_probes: int = 32,
    max_rounds: int = 16,
):
    """Insert-if-absent a batch of UNIQUE packed key pairs (N, 2); invalid
    rows are ignored. Returns (table, slot (N,) int32, ok (N,) bool).
    The returned table is a new tensor; the input is not modified."""
    with span("hash.activate"):
        C = table.shape[0]
        N = keys.shape[0]
        dev = keys.device
        h = _home(keys, C)
        k0, k1 = keys[..., 0], keys[..., 1]
        ids = torch.arange(N, dtype=torch.int64, device=dev)
        big = N + 1

        slot0, found0 = find(table, keys, max_probes)
        slot = slot0.to(torch.int64)
        done = found0 | ~is_valid(keys)
        p = torch.zeros(N, dtype=torch.int64, device=dev)
        # one spare row: scatters of lanes that do not win land there and are
        # dropped (JAX's mode="drop")
        ext = torch.cat([table, table.new_zeros((1, 2))])
        for _ in range(max_rounds):
            if host_read("hash.claim", done.all()):
                break
            count("hash.claim_rounds")
            s = (h + p) % C
            cur = ext[s]
            hit = (cur[..., 0] == k0) & (cur[..., 1] == k1) & ~done
            slot = torch.where(hit, s, slot)
            done = done | hit
            free = ((cur[..., 1] & 1) == 0) & ~done  # empty or tombstone
            claim = torch.full((C + 1,), big, dtype=torch.int64, device=dev)
            claim.scatter_reduce_(0, torch.where(free, s, C), torch.where(free, ids, big), "amin")
            win = free & (claim[s] == ids)
            dst = torch.where(win, s, C)
            ext.index_copy_(0, dst, torch.where(win[:, None], keys, 0))
            ext[C].zero_()  # not `= 0`, which reads a host scalar back on a card
            slot = torch.where(win, s, slot)
            done = done | win
            advance = ~done & ((cur[..., 1] & 1) == 1) & ~hit
            p = p + advance.to(torch.int64)
        ok = done & is_valid(keys)
        return ext[:C].contiguous(), slot.to(torch.int32), ok


def erase(table: torch.Tensor, keys: torch.Tensor, max_probes: int = 32):
    """Remove packed keys (N, 2): their slots become tombstones, so the
    probe chains through them stay intact. Returns (table, erased (N,)
    bool); the table is a new tensor, the input is not modified."""
    slot, found = find(table, keys, max_probes)
    C = table.shape[0]
    tomb = torch.stack([torch.zeros_like(slot), torch.full_like(slot, _TOMB_W1)], dim=-1)
    # keys not found write into a spare row, dropped (JAX's mode="drop")
    ext = torch.cat([table, table.new_zeros((1, 2))])
    ext[torch.where(found, slot, C).to(torch.int64)] = torch.where(found[:, None], tomb, 0)
    return ext[:C].contiguous(), found


def unique_keys(keys: torch.Tensor, capacity: int):
    """Deduplicate packed key pairs (N, 2) into a fixed-capacity array.
    Returns (unique (capacity, 2) int32 invalid-padded, count () int32).
    count is the pre-clamp unique total (> capacity means truncation).

    The JAX package sorts the two words as two int32 keys; here one stable
    sort runs on an int64 key w0 * 2^32 + (w1 + 2^31), which has the same
    signed lexicographic order."""
    N = keys.shape[0]
    if N < capacity:
        keys = torch.cat([keys, empty_keys(capacity - N, device=keys.device)])
    ok = is_valid(keys)
    w0 = torch.where(ok, keys[..., 0], 0x7FFFFFFF).to(torch.int64)
    w1 = torch.where(ok, keys[..., 1], 0x7FFFFFFE).to(torch.int64)
    k = (w0 << 32) + (w1 + (1 << 31))
    s, _ = torch.sort(k, stable=True)
    s1 = (s & _U32) - (1 << 31)
    sval = (s1 & 1) == 1
    first = torch.ones_like(sval)
    first[1:] = s[1:] != s[:-1]
    first = first & sval
    count = first.to(torch.int32).sum()
    _, order = torch.sort((~first).to(torch.int8), stable=True)
    out = s[order[:capacity]]
    out = torch.stack([(out >> 32).to(torch.int32), ((out & _U32) - (1 << 31)).to(torch.int32)], dim=-1)
    live = torch.arange(capacity, device=keys.device) < count
    out = torch.where(live[:, None], out, 0)
    return out, count


def occupied_mask(table: torch.Tensor) -> torch.Tensor:
    """(C,) bool: slot holds a live key."""
    return (table[..., 1] & 1) == 1


def active_slots(table: torch.Tensor, capacity: int):
    """The occupied slots in ascending order, padded with -1 to `capacity`.
    Returns (slots (capacity,) int32, count () int32 clamped to capacity)."""
    occ = occupied_mask(table)
    C = table.shape[0]
    rank = torch.cumsum(occ.to(torch.int64), 0) - 1
    count = occ.to(torch.int32).sum()
    dst = torch.where(occ & (rank < capacity), rank, capacity)
    out = torch.full((capacity + 1,), -1, dtype=torch.int32, device=table.device)
    out.scatter_(0, dst, torch.arange(C, dtype=torch.int32, device=table.device))
    return out[:capacity], torch.clamp(count, max=capacity)


def resize(table: torch.Tensor, new_capacity: int):
    """Rehash into a table of `new_capacity` slots (larger, or smaller if
    the keys fit) on the table's device. Returns (new_table, old_slots (C,)
    int32, new_slots (C,) int32, count): for i < count the key at
    old_slots[i] now lives at new_slots[i] (-1 where it did not fit), which
    callers use to move their value rows."""
    C = table.shape[0]
    old_slots, count = active_slots(table, C)
    keys = table[torch.clamp(old_slots, min=0).to(torch.int64)]
    keys = torch.where((old_slots >= 0)[:, None], keys, 0)
    new_table, new_slots, ok = activate(make_table(new_capacity, device=table.device), keys,
                                        max_rounds=64)
    return new_table, old_slots, torch.where(ok, new_slots, -1), count
