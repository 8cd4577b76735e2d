"""DeviceHashTable — a capacity-bounded hash table on one device.

Counterpart of ``harmony_tpu/table/hashtable.py``: the table for sparse key
domains (embedding ids, word ids drawn from the whole int32 range), where
``getOrInit`` admits any key on first touch and ``capacity`` bounds slots, not
keys.

Storage is a pair of tensors, ``slot_keys [num_blocks, block_slots]`` (int32;
0 = empty, a present key k is stored as ``-(k + 2)``) and ``values
[num_blocks, block_slots, *value_shape]``. A key hashes to its block and then
double-hash probes within that block's power-of-two slot count. The hashes are
the reference's uint32 arithmetic, computed in int64 tensors masked to 32 bits
(as ``utils/prng.py`` does), so every slot placement is byte-identical to the
JAX package's.

The device ops, for one batch of keys and no host sync:

  * :meth:`HashTableSpec.ensure` resolves every key in ``max_probes`` rounds
    of gather, claim and read-back. A claim is a min-scatter
    (``scatter_reduce_(..., "amin")``) of the stored encoding onto the int32
    slot keys: an integer min does not depend on the order of the writes, so
    racing keys resolve to the reference's winner on the card too; losers
    probe on. A key that exhausts its probes, or lies outside [MIN_KEY,
    MAX_KEY], comes back ``ok=False``: it reads its init value and its push
    is dropped, and the caller counts it.
  * :meth:`HashTableSpec.pull` reads the values at the resolved slots through
    ``gather_rows`` (K1).
  * :meth:`HashTableSpec.push` in ``add`` mode groups the batch by target slot
    (a stable sort), folds each slot's deltas in batch order from 0.0 with
    ``segment_sum_rows`` (K2), and writes each touched slot once, as its value
    plus its fold. No float atomics: the card and the CPU give the same bits.
    The reference adds duplicates one after another onto the stored value, so
    against it float values agree to a tolerance and integer-valued ones
    exactly. ``min``/``max`` fold per slot first; ``set`` and ``put`` are exact
    sets by the last duplicate, giving the reference's bits, the sign of a
    zero included (its add-pair set stores ``new + 0.0``).

As ``DenseTable``'s, the ops update the storage IN PLACE and return it; the
table lock serialises a step with its commit and with host readers. Every
write of rows goes through :meth:`HashTableSpec._write_rows`, which never
depends on an order of writes (see there).

The checkpoint path's per-block I/O (``snapshot_blocks``, ``export_blocks``,
``import_blocks``) moves a block as its (slot_keys, values) pair, so a
restored table places every key in the slot it had.

Over a mesh of several slots the state is a ``ShardedArray`` of (slot_keys,
values) pairs placed by ``block_sharding``, as the reference's
``_make_shardings`` places both arrays. A key hashes to its block and probes
only inside it, so each slot runs ``ensure``, the lookup and the push on the
keys of its own blocks (keys of other blocks are masked out, in their batch
order), and every replica admits the same keys in the same order. A pull
reads with K1 once on each shard of its data row, a push folds with K2 once
on each slot; the slot placements and values are the one-slot table's, byte
for byte. ``reshard`` moves the slot keys and the values together onto a new
mesh (``table/blockmove.py``), so every key keeps its slot.

Over the processes of a pod each process admits, reads and folds on its own
shards only (the probe loop runs there), and a pull's tokens and rows of the
other shards come from an all-gather, picked by shard as the dense table's
are (``table.combine_owned``). ``addressable_blocks`` gives the pod's
checkpoint each process's owned block pairs (``table.owned_blocks``).
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from harmony_tpu_torch.config.params import TableConfig
from harmony_tpu_torch.ops.sparse import gather_rows, segment_sum_rows, value_width
from harmony_tpu_torch.parallel.mesh import Mesh
from harmony_tpu_torch.parallel.dispatch import dispatch_scope
from harmony_tpu_torch.table.table import (
    BlockSnapshot,
    LayoutAnnouncerMixin,
    ShardedArray,
    StreamOrder,
    _import_part,
    combine_owned,
    _sharding_of,
    _snapshot_part,
    block_sharding,
    mesh_of,
    on_device,
    owned_blocks,
    reshard_array,
)
from harmony_tpu_torch.table.update import UpdateFunction, get_update_fn
from harmony_tpu_torch.utils.platform import DeviceLike

# Stored-key encoding: key k (MIN_KEY <= k <= MAX_KEY) is stored as -(k + 2);
# empty slots hold 0. Key 0 is reserved, as in the reference (there it is
# XLA's pad value): valid keys are 1..MAX_KEY.
EMPTY_STORED = 0
MAX_KEY = 2**31 - 3  # -(k + 2) must not wrap int32
MIN_KEY = 1

_MASK = 0xFFFFFFFF
# The linear slot of an entry left out of a grouping: it sorts after every
# real slot.
_NO_SLOT = 2**31 - 1

State = Tuple[torch.Tensor, torch.Tensor]
Token = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _encode_keys(keys: torch.Tensor) -> torch.Tensor:
    return (-(keys.to(torch.int64) + 2)).to(torch.int32)


def _decode_stored(sk: np.ndarray) -> np.ndarray:
    return (-sk.astype(np.int64) - 2).astype(np.int32)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def as_uint32(x: torch.Tensor) -> torch.Tensor:
    """An integer tensor's values as uint32 (a negative int32 k becomes
    2**32 + k), held in int64."""
    return x.to(torch.int64) & _MASK


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c`` mod 2**32 for int64 tensors of uint32 values and a uint32
    constant, in halves so that no product leaves int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK


def mix32(x: torch.Tensor, seed: int) -> torch.Tensor:
    """The reference's ``_mix32``, a Murmur3-style finalizer over uint32, on
    int64 tensors of uint32 values."""
    x = x ^ (seed & _MASK)
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


class HashTableSpec:
    """Static description and device ops of a hash table.

    ``config.capacity`` is the total SLOT budget, rounded up so that each
    block holds a power-of-two slot count (double hashing with an odd stride
    then cycles the whole block); the block count stays ``config.num_blocks``.
    """

    # Blocks must hold enough slots for probing to work (the reference's
    # floor): block_slots is raised to it, never the block count.
    MIN_BLOCK_SLOTS = 32

    def __init__(self, config: TableConfig, update_fn: Optional[UpdateFunction] = None,
                 max_probes: int = 16) -> None:
        self.config = config
        self.update_fn = update_fn or get_update_fn(config.update_fn)
        self.num_blocks = config.num_blocks
        raw = _next_pow2(max(1, -(-config.capacity // config.num_blocks)))
        floor = min(self.MIN_BLOCK_SLOTS, _next_pow2(config.capacity))
        self.block_slots = max(raw, floor)
        self.max_probes = min(max_probes, self.block_slots)
        self.value_shape: Tuple[int, ...] = tuple(config.value_shape)
        self.width = value_width(self.value_shape)
        self.dtype: torch.dtype = getattr(torch, config.dtype)

    @property
    def table_id(self) -> str:
        return self.config.table_id

    @property
    def num_slots(self) -> int:
        return self.num_blocks * self.block_slots

    @property
    def block_size(self) -> int:
        """Slots per block (the checkpoint manager's per-block row count)."""
        return self.block_slots

    @property
    def keys_shape(self) -> Tuple[int, int]:
        return (self.num_blocks, self.block_slots)

    @property
    def values_shape(self) -> Tuple[int, ...]:
        return (self.num_blocks, self.block_slots, *self.value_shape)

    # -- hashing ---------------------------------------------------------

    def _route(self, keys: torch.Tensor):
        """key -> (owning block, probe start, odd probe stride), int64."""
        u = as_uint32(keys)
        block = mix32(u, 0x9E3779B9) % self.num_blocks
        start = mix32(u, 0x7F4A7C15) % self.block_slots
        stride = ((mix32(u, 0x94D049BB) | 1) % self.block_slots) | 1
        return block, start, stride

    def _probe_slot(self, start: torch.Tensor, stride: torch.Tensor, r: int) -> torch.Tensor:
        return (start + stride * r) % self.block_slots

    def _lin(self, block: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
        """Row of (block, slot) in the flat ``[num_slots, width]`` values."""
        return block * self.block_slots + slot

    def _flat(self, values: torch.Tensor) -> torch.Tensor:
        """Values as rows ``[slots, width]`` (the whole table's, or a shard's)."""
        return values.view(-1, self.width)

    def _in_shard(self, block: torch.Tensor, lo: int, nb: int):
        """For a shard holding blocks [lo, lo + nb): the mask of keys whose
        block it holds (None when it holds them all) and each key's block
        within the shard (0 for the others)."""
        if nb == self.num_blocks:
            return None, block
        inside = (block >= lo) & (block < lo + nb)
        return inside, torch.where(inside, block - lo, 0)

    # -- pure parts ------------------------------------------------------

    def init_state(self, device: torch.device) -> State:
        """Empty table: every slot empty (0), values zeroed."""
        return (torch.zeros(self.keys_shape, dtype=torch.int32, device=device),
                torch.zeros(self.values_shape, dtype=self.dtype, device=device))

    def _init_values(self, keys: torch.Tensor) -> torch.Tensor:
        """Init values ``[n, *value_shape]`` of ``keys`` [n]. Float values are
        kept finite (+-inf inits clamp to the dtype's extremes), as in the
        reference, whose exact sets are built from add-pairs."""
        n = keys.shape[0]
        vals = self.update_fn.init(keys)
        if vals.ndim == 1 and self.value_shape:
            vals = vals.reshape(-1, *([1] * len(self.value_shape))).expand(
                n, *self.value_shape)
        vals = vals.to(self.dtype)
        if vals.is_floating_point():
            info = torch.finfo(self.dtype)
            vals = torch.nan_to_num(vals, posinf=info.max, neginf=info.min)
        return vals.reshape(n, *self.value_shape)

    def _slot_groups(self, block, slot, mask):
        """The batch grouped by target slot: a stable sort on the linear slot
        (entries outside ``mask`` sort last, as one group of their own).
        Returns (perm, sorted linear slots, group-start flags)."""
        lin = torch.where(mask, self._lin(block, slot), _NO_SLOT)
        sl, perm = torch.sort(lin, stable=True)
        start = torch.ones_like(sl, dtype=torch.bool)
        start[1:] = sl[1:] != sl[:-1]
        return perm, sl, start

    def _one_writer_per_slot(self, block, slot, mask) -> torch.Tensor:
        """Per entry: is it the LAST entry under ``mask`` of its target slot (the
        reference's per-key ordering makes the last duplicate win)."""
        perm, sl, _ = self._slot_groups(block, slot, mask)
        is_last = torch.ones_like(sl, dtype=torch.bool)
        is_last[:-1] = sl[1:] != sl[:-1]
        win = is_last & (sl != _NO_SLOT)
        return win[torch.argsort(perm)]

    def _any_per_slot(self, block, slot, mask) -> torch.Tensor:
        """Per entry: does any entry of its target slot have ``mask`` set."""
        perm, sl, start = self._slot_groups(block, slot, mask)
        gid = torch.cumsum(start.to(torch.int64), 0) - 1
        seg = torch.zeros_like(gid).scatter_reduce_(
            0, gid, mask[perm].to(torch.int64), "amax")
        return (seg[gid] > 0)[torch.argsort(perm)]

    def _fold_per_slot(self, block, slot, mask, deltas, mode: str) -> torch.Tensor:
        """Per entry: the min or max over all ``mask`` entries of its slot."""
        perm, sl, start = self._slot_groups(block, slot, mask)
        gid = torch.cumsum(start.to(torch.int64), 0) - 1
        d = deltas.reshape(deltas.shape[0], -1)[perm]
        seg = d.new_zeros(d.shape).scatter_reduce_(
            0, gid[:, None].expand_as(d), d, "amin" if mode == "min" else "amax",
            include_self=False)
        return seg[gid][torch.argsort(perm)].reshape(deltas.shape)

    @staticmethod
    def _write_rows(flat: torch.Tensor, lin: torch.Tensor, rows: torch.Tensor,
                    mask: torch.Tensor) -> None:
        """``flat[lin[i]] = rows[i]`` where ``mask[i]``, in one indexed write
        with no host sync and no dependence on the order of its writes.

        Callers give the unmasked entries of one target identical rows. A
        masked-out entry repeats the first unmasked entry's write, or, when no
        entry is unmasked, rewrites row 0 with its own bytes: every write to a
        row then carries the same bytes, whatever order they land in."""
        if lin.numel() == 0:
            return
        rows = rows.to(flat.dtype)
        # one-element index_select, not x[t]: indexing by a 0-d tensor reads
        # it on the host, a sync
        first = torch.argmax(mask.to(torch.int32)).view(1)
        some = mask.any().view(1)
        fb_lin = torch.where(some, lin.index_select(0, first), 0)
        fb_row = torch.where(some[:, None], rows.index_select(0, first), flat[:1])
        flat.index_put_((torch.where(mask, lin, fb_lin),),
                        torch.where(mask[:, None], rows, fb_row))

    def ensure(self, state: State, keys: torch.Tensor,
               init_v: Optional[torch.Tensor] = None) -> Tuple[State, Token]:
        """getOrInit admission: resolve every key to a slot, inserting missing
        keys (value = ``update_fn.init(key)``). Returns ``(state, (block, slot,
        ok))``; ``ok=False`` marks keys out of domain or past the probe budget.
        Duplicate keys resolve to one slot; distinct keys racing for one empty
        slot are arbitrated by the min-claim and its read-back. ``init_v``:
        the keys' init values when the caller has them. On a
        :class:`ShardedArray` every slot admits the keys of its blocks."""
        keys = keys.reshape(-1).to(torch.int32)
        if init_v is None:
            init_v = self._init_values(keys)
        if isinstance(state, ShardedArray):
            return state, self._ensure_sharded(state, keys, init_v)
        slot_keys, values = state
        return state, self._ensure_in(slot_keys, values, keys, init_v, 0)

    def _ensure_in(self, slot_keys: torch.Tensor, values: torch.Tensor,
                   keys: torch.Tensor, init_v: torch.Tensor, lo: int) -> Token:
        """:meth:`ensure` on storage holding blocks [lo, lo + its blocks):
        keys of other blocks come back ``ok=False``. The token's block is
        the key's block in the whole table."""
        n = keys.shape[0]
        valid = (keys >= MIN_KEY) & (keys <= MAX_KEY)
        enc = _encode_keys(keys)
        block, start, stride = self._route(keys)
        inside, blk = self._in_shard(block, lo, slot_keys.shape[0])
        if inside is not None:
            valid = valid & inside
        base = blk * self.block_slots
        flat_keys = slot_keys.view(-1)
        slot = torch.full_like(block, -1)
        fresh = torch.zeros_like(valid)
        no_claim = torch.full_like(enc, EMPTY_STORED)
        for r in range(self.max_probes):
            cand = self._probe_slot(start, stride, r)
            lin = base + cand
            sk = flat_keys[lin]
            need = valid & (slot < 0)
            is_match = need & (sk == enc)
            is_empty = need & (sk == EMPTY_STORED)
            # non-claimers write 0: the min's identity against every stored
            # value (empty 0, keys < 0)
            flat_keys.scatter_reduce_(0, lin, torch.where(is_empty, enc, no_claim), "amin")
            won = is_empty & (flat_keys[lin] == enc)
            slot = torch.where(is_match | won, cand, slot)
            fresh = fresh | won
        ok = valid & (slot >= 0)
        safe_slot = slot.clamp_min(0)
        # a fresh slot holds zeros: one write of zeros + init per slot (the
        # reference's one additive write), duplicates of a new key deduped
        fresh = self._one_writer_per_slot(blk, safe_slot, fresh)
        flat = self._flat(values)
        lin = base + safe_slot
        self._write_rows(flat, lin, flat[lin] + init_v.reshape(n, self.width), fresh)
        return block, safe_slot, ok

    def _ensure_sharded(self, state: ShardedArray, keys: torch.Tensor,
                        init_v: torch.Tensor) -> Token:
        """Every slot admits the keys of its shard (each replica the same
        keys in the same order, so every replica places them alike); the
        token is the owning shards' slots, on ``state.device``."""
        sh, dev = state.sharding, state.device
        block = self._route(keys)[0]
        shard = torch.div(block, sh.blocks_per_shard, rounding_mode="floor")
        row0 = {s: k for k, s in sh.read_slots(state.row).items()}
        slot = torch.zeros_like(block)
        ok = torch.zeros_like(keys, dtype=torch.bool)
        moved: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}
        with dispatch_scope(sh.mesh):
            for s, (sk, v) in state.shards.items():
                if sk.device not in moved:
                    moved[sk.device] = (on_device(keys, sk.device), on_device(init_v, sk.device))
                kk, iv = moved[sk.device]
                k = sh.shard_of(s)
                _, slot_k, ok_k = self._ensure_in(sk, v, kk, iv, k * sh.blocks_per_shard)
                if s in row0:
                    mine = shard == k
                    slot = torch.where(mine, on_device(slot_k, dev), slot)
                    ok = torch.where(mine, on_device(ok_k, dev), ok)
            if len(row0) < sh.num_shards:
                both = combine_owned(sh, state.row, shard,
                                     torch.stack([slot, ok.to(slot.dtype)], 1))
                slot, ok = both[:, 0].contiguous(), both[:, 1] != 0
        return block, slot, ok

    def lookup(self, state: State, keys: torch.Tensor) -> torch.Tensor:
        """Read-only multiGet: values of present keys, init values of absent
        ones; nothing is inserted (``get`` as against ``getOrInit``). On a
        :class:`ShardedArray`, K1 once on each shard of the row."""
        keys = keys.reshape(-1).to(torch.int32)
        n = keys.shape[0]
        if isinstance(state, ShardedArray):
            sh, dev = state.sharding, state.device
            found, got = None, None
            with dispatch_scope(sh.mesh):
                for k, (sk, v) in state.local_reads():
                    f_k, g_k = self._lookup_in(sk, v, on_device(keys, sk.device),
                                               k * sh.blocks_per_shard)
                    f_k, g_k = on_device(f_k, dev), on_device(g_k, dev)
                    found = f_k if found is None else found | f_k
                    got = g_k if got is None else torch.where(f_k[:, None], g_k, got)
                if len(sh.read_slots(state.row)) < sh.num_shards:
                    shard = torch.div(self._route(keys)[0].to(dev), sh.blocks_per_shard,
                                      rounding_mode="floor")
                    found = combine_owned(sh, state.row, shard, found)
                    got = combine_owned(sh, state.row, shard, got)
        else:
            found, got = self._lookup_in(state[0], state[1], keys, 0)
        init_v = self._init_values(keys).reshape(n, self.width)
        return torch.where(found[:, None], got, init_v).reshape(n, *self.value_shape)

    def _lookup_in(self, slot_keys: torch.Tensor, values: torch.Tensor,
                   keys: torch.Tensor, lo: int):
        """(found, rows) of ``keys`` in storage holding blocks [lo, ...):
        the probe, then K1 at the found slots."""
        valid = (keys >= MIN_KEY) & (keys <= MAX_KEY)
        enc = _encode_keys(keys)
        block, start, stride = self._route(keys)
        inside, blk = self._in_shard(block, lo, slot_keys.shape[0])
        if inside is not None:
            valid = valid & inside
        base = blk * self.block_slots
        flat_keys = slot_keys.view(-1)
        slot = torch.full_like(block, -1)
        for r in range(self.max_probes):
            cand = self._probe_slot(start, stride, r)
            hit = valid & (slot < 0) & (flat_keys[base + cand] == enc)
            slot = torch.where(hit, cand, slot)
        found = valid & (slot >= 0)
        got = gather_rows(self._flat(values), (base + slot.clamp_min(0)).to(torch.int32))
        return found, got

    def pull(self, state: State, keys: torch.Tensor):
        """getOrInit pull: admit, then read the values at the resolved slots
        through ``gather_rows`` (K1). Returns ``(state, values, token)``; the
        token goes to :meth:`push` for the same keys (no second probe)."""
        keys = keys.reshape(-1).to(torch.int32)
        init_v = self._init_values(keys)
        state, token = self.ensure(state, keys, init_v)
        return state, self._read(state, token, init_v), token

    def read(self, state: State, keys: torch.Tensor, token: Token) -> torch.Tensor:
        """The values of ``keys`` at slots :meth:`ensure` resolved (``token``):
        what :meth:`pull` returns. On a :class:`ShardedArray`, read on the
        shards of its data row."""
        keys = keys.reshape(-1).to(torch.int32)
        return self._read(state, token, self._init_values(keys))

    def _read(self, state, token: Token, init_v: torch.Tensor) -> torch.Tensor:
        block, slot, ok = token
        n = ok.shape[0]
        if isinstance(state, ShardedArray):
            sh, dev = state.sharding, state.device
            bps = sh.blocks_per_shard
            vals = None
            with dispatch_scope(sh.mesh):
                for k, (_, v) in state.local_reads():
                    inside, blk = self._in_shard(block, k * bps, v.shape[0])
                    lin = self._lin(blk, slot).to(torch.int32)
                    got = on_device(gather_rows(self._flat(v), on_device(lin, v.device)), dev)
                    vals = got if vals is None else torch.where(inside[:, None], got, vals)
                if len(sh.read_slots(state.row)) < sh.num_shards:
                    shard = torch.div(block, bps, rounding_mode="floor")
                    vals = combine_owned(sh, state.row, shard, vals)
        else:
            vals = gather_rows(self._flat(state[1]), self._lin(block, slot).to(torch.int32))
        vals = torch.where(ok[:, None], vals, init_v.reshape(n, self.width))
        return vals.reshape(n, *self.value_shape)

    def _exact_set(self, flat, block, slot, mask, new_vals, win=None) -> None:
        """Exact overwrite at resolved slots by one writer per slot (the last
        duplicate under ``mask``). The reference writes ``(cur - cur) + new``
        with two add-scatters, which for finite values is ``new + 0.0``: a
        -0.0 is stored as +0.0, here too."""
        if win is None:
            win = self._one_writer_per_slot(block, slot, mask)
        rows = new_vals.reshape(mask.shape[0], self.width).to(flat.dtype)
        if rows.is_floating_point():
            rows = rows + 0.0
        self._write_rows(flat, self._lin(block, slot), rows, win)

    def put(self, state: State, token: Token, values_in: torch.Tensor) -> State:
        """Overwrite-put at slots resolved by :meth:`ensure` (put/multiPut
        semantics, whatever the update fn)."""
        def put_in(values, block, slot, ok, rows):
            self._exact_set(self._flat(values), block, slot, ok, rows)

        return self._on_shards(state, token, values_in, put_in)

    def _on_shards(self, state, token: Token, rows: torch.Tensor, fn) -> State:
        """Run ``fn(values, block, slot, ok, rows)`` on the storage, or on
        every slot of a ShardedArray with the token cut to its shard (block
        within the shard, ``ok`` false for the keys of other shards)."""
        block, slot, ok = token
        if not isinstance(state, ShardedArray):
            fn(state[1], block, slot, ok, rows)
            return state
        sh = state.sharding
        moved: Dict[torch.device, tuple] = {}
        with dispatch_scope(sh.mesh):
            for s, (_, v) in state.shards.items():
                if v.device not in moved:
                    moved[v.device] = tuple(on_device(t, v.device)
                                            for t in (block, slot, ok, rows))
                b, sl, o, r = moved[v.device]
                inside, blk = self._in_shard(b, sh.shard_of(s) * sh.blocks_per_shard,
                                             v.shape[0])
                fn(v, blk, sl, o if inside is None else o & inside, r)
        return state

    def _add_folded(self, flat, block, slot, ok, deltas) -> None:
        """``add``: each touched slot's deltas folded in batch order from 0.0
        (K2 for floats; an exact integer sum otherwise), then one write a slot
        of value + fold. Every entry of a slot writes the same row."""
        perm, sl, start = self._slot_groups(block, slot, ok)
        n = sl.shape[0]
        gid = torch.cumsum(start.to(torch.int64), 0) - 1
        live = sl != _NO_SLOT
        d = deltas[perm]
        if d.is_floating_point():
            folded = segment_sum_rows(d.float().contiguous(),
                                      torch.where(live, gid, -1).to(torch.int32), n)
        else:
            folded = torch.zeros_like(d).index_add_(
                0, gid, torch.where(live[:, None], d, torch.zeros_like(d)))
        tgt = torch.where(live, sl, 0)
        cur = flat[tgt]
        new = (cur.float() + folded[gid]) if d.is_floating_point() else cur + folded[gid]
        self._write_rows(flat, tgt, new, live)

    def push(self, state: State, token: Token, deltas: torch.Tensor) -> State:
        """multiUpdate at slots resolved by :meth:`pull`/:meth:`ensure`.
        Duplicate keys fold per the update fn's ``scatter_mode``; entries with
        ``ok=False`` are dropped. ``post`` then applies to every touched slot
        by an exact set. On a :class:`ShardedArray` every slot folds the keys
        of its shard (K2 once a slot), in their batch order."""
        deltas = deltas.reshape(token[2].shape[0], self.width).to(self.dtype)
        return self._on_shards(state, token, deltas, self._push_in)

    def _push_in(self, values, block, slot, ok, deltas) -> None:
        flat = self._flat(values)
        mode = self.update_fn.scatter_mode
        if mode == "add":
            self._add_folded(flat, block, slot, ok, deltas)
        elif mode in ("min", "max"):
            folded = self._fold_per_slot(block, slot, ok, deltas, mode)
            cur = flat[self._lin(block, slot)]
            comb = torch.minimum(cur, folded) if mode == "min" else torch.maximum(cur, folded)
            self._exact_set(flat, block, slot, ok, comb)
        elif mode == "set":
            self._exact_set(flat, block, slot, ok, deltas)
        else:
            raise ValueError(f"unknown scatter_mode {mode!r}")
        if self.update_fn.post is not None:
            touched = self._any_per_slot(block, slot, ok)
            win = self._one_writer_per_slot(block, slot, touched)
            upd = flat[self._lin(block, slot)]
            self._exact_set(flat, block, slot, touched, self.update_fn.post(upd), win=win)


class DeviceHashTable(StreamOrder, LayoutAnnouncerMixin):
    """Host-side handle of a hash table, on one slot or over a mesh:
    serialised steps and commits, the host op surface (multi_get_or_init,
    multi_get, multi_update, multi_put) and the overflow count. Device work is ordered across streams
    as ``DenseTable``'s is (:class:`StreamOrder`), and writes bump
    ``data_version``, which the reference's hash table lacks (its serving
    cache keeps a hash table's rows across training writes; ROADMAP C).

    Keys the table refuses (out of domain, or past the probe budget) are
    counted in :attr:`overflow_count`, never dropped silently: the host ops
    count their own, and a training step's per-batch counts are folded in
    with :meth:`count_dropped` at its epoch's drain."""

    def __init__(self, spec: HashTableSpec, mesh: "Mesh | DeviceLike" = None,
                 state: Optional[State] = None) -> None:
        self.spec = spec
        self.mesh = mesh_of(mesh)
        # the reference's _make_shardings: slot keys and values alike
        self.sharding = block_sharding(self.mesh, spec.num_blocks)
        self.device = self.sharding.compute_slot().device
        self._lock = threading.RLock()
        if state is None:
            state = spec.init_state(self.device)
        else:
            self._check_state(state)
            state = (state[0].to(self.device, torch.int32).contiguous(),
                     state[1].to(self.device, spec.dtype).contiguous())
        if self.mesh.size > 1:
            state = ShardedArray.split(self.sharding, *state)
        self._state = state
        self._dropped = False
        self.overflow_count = 0
        self._layout_listeners: list = []
        self._init_order()

    def _check_state(self, state) -> None:
        sk, v = state
        if tuple(sk.shape) != self.spec.keys_shape or tuple(v.shape) != self.spec.values_shape:
            raise ValueError(f"state shapes {tuple(sk.shape)}, {tuple(v.shape)} != "
                             f"{self.spec.keys_shape}, {self.spec.values_shape}")

    def _check(self) -> None:
        if self._dropped:
            raise RuntimeError(f"table {self.spec.table_id} was dropped")

    @property
    def state(self) -> State:
        """The live (slot_keys, values) pair. Steps update it in place."""
        with self._lock:
            self._check()
            return self._state

    @property
    def _step_state(self) -> State:
        return self._state

    def commit(self, new_state: State) -> None:
        """Install the post-step state (a step that updated in place hands back
        the same tensors, or the same shards). A state computed on the layout
        before a reshard is re-homed onto the current one."""
        with self._lock:
            self._check()
            src = _sharding_of(new_state, self.sharding)
            if src != self.sharding:
                new_state = reshard_array(new_state, src, self.sharding)
            if isinstance(self._state, ShardedArray) or isinstance(new_state, ShardedArray):
                self._state = ShardedArray(new_state.sharding, new_state.shards)
                self._after_write()
                return
            self._check_state(new_state)
            sk, v = new_state
            if (sk.dtype != torch.int32 or v.dtype != self.spec.dtype
                    or sk.device != self._state[0].device
                    or v.device != self._state[1].device):
                raise ValueError("commit: state dtype or device changed")
            self._state = (sk, v)
            self._after_write()

    def apply_step(self, step_fn: Callable, *args):
        """Run ``step_fn(state, *args) -> (new_state, out)`` and commit, both
        under the table lock. Returns ``out``."""
        with self._lock, dispatch_scope(self.mesh):
            self._check()
            self._before_write()
            new_state, out = step_fn(self._state, *args)
            self.commit(new_state)
        return out

    def apply_step_with(self, local, step_fn: Callable, *extra):
        """Run ``step_fn(state, local_arr, *extra) -> ((new_state, new_local),
        aux)`` and commit both (a hash model table beside a dense worker-local
        table: sparse LDA). Lock order as ``DenseTable.apply_step_with``: this
        table's lock, then ``local``'s."""
        with self._lock, local._lock, dispatch_scope(
                max(self.mesh, local.mesh, key=lambda m: m.size)):
            self._check()
            self._before_write()
            local._before_write()
            (new_state, new_local), aux = step_fn(self._state, local._step_state, *extra)
            self.commit(new_state)
            local.commit(new_local)
        return aux

    # -- host op surface ---------------------------------------------------

    def _keys(self, keys) -> torch.Tensor:
        if isinstance(keys, torch.Tensor):
            return keys.reshape(-1).to(self.device, torch.int32)
        return torch.as_tensor(np.asarray(keys, dtype=np.int64).astype(np.int32).reshape(-1),
                               device=self.device)

    def _rows(self, x) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x)
        return torch.as_tensor(x, device=self.device)

    def count_dropped(self, n: int) -> None:
        """Fold drops observed elsewhere (a training step's per-batch counts)
        into :attr:`overflow_count`. Thread-safe."""
        with self._lock:
            self.overflow_count += int(n)

    def multi_get_or_init(self, keys: Sequence[int]) -> np.ndarray:
        """getOrInit pull; keys the table cannot admit read as init and count
        in :attr:`overflow_count`."""
        spec = self.spec

        def step(state, k):
            state, vals, (_, _, ok) = spec.pull(state, k)
            return state, (vals, (~ok).sum())

        vals, dropped = self.apply_step(step, self._keys(keys))
        self.count_dropped(int(dropped))
        return vals.cpu().numpy()

    def multi_get(self, keys: Sequence[int]) -> np.ndarray:
        """Read-only lookup: absent keys read as init and are not inserted.
        Dispatched under the lock after the last committed write; the wait
        for the rows and their copy to the host happen outside it."""
        k = self._keys(keys)
        with self._lock:
            self._check()
            self._before_read()
            rows = self.spec.lookup(self._state, k)
            self._after_read()
        return rows.cpu().numpy()

    def multi_update(self, keys: Sequence[int], deltas) -> int:
        """multiUpdate; returns the number of keys dropped (and counts them)."""
        spec = self.spec

        def step(state, k, d):
            state, token = spec.ensure(state, k)
            return spec.push(state, token, d), (~token[2]).sum()

        dropped = int(self.apply_step(step, self._keys(keys), self._rows(deltas)))
        self.count_dropped(dropped)
        return dropped

    def multi_put(self, keys: Sequence[int], values) -> int:
        """Bulk overwrite-put (the bulk-load path); returns the keys dropped."""
        spec = self.spec

        def step(state, k, v):
            state, token = spec.ensure(state, k)
            return spec.put(state, token, v), (~token[2]).sum()

        dropped = int(self.apply_step(step, self._keys(keys), self._rows(values)))
        self.count_dropped(dropped)
        return dropped

    def num_present(self) -> int:
        """Occupied slots (stored keys are negative)."""
        with self._lock:
            self._check()
            self._before_read()
            n = (self._slot_keys() < 0).sum()
            self._after_read()
        return int(n)

    def _slot_keys(self) -> torch.Tensor:
        """Every block's slot keys, block-major on ``device`` (a copy when
        sharded)."""
        st = self._state
        return st.whole(0) if isinstance(st, ShardedArray) else st[0]

    def items(self) -> Dict[int, np.ndarray]:
        """Every present (key, value) pair (a test and debug surface)."""
        with self._lock:
            self._check()
            self._before_read()
            st = self._state
            sk, v = ((st.whole(0), st.whole(1)) if isinstance(st, ShardedArray)
                     else (t.clone() for t in st))
            self._after_read()
        sk = sk.cpu().numpy().reshape(-1)
        v = v.cpu().numpy().reshape(-1, *self.spec.value_shape)
        return {int(_decode_stored(sk[i])): v[i] for i in np.nonzero(sk < 0)[0]}

    def drop(self) -> None:
        with self._lock:
            self._dropped = True
            self._state = None

    # -- per-block I/O (the checkpoint path) ------------------------------

    def snapshot_blocks(self, block_ids: Optional[Sequence[int]] = None
                        ) -> BlockSnapshot:
        """Device-side snapshot: the blocks' slot keys and values, COPIED
        under the table lock on the calling thread's stream (steps update the
        state in place; see ``DenseTable.snapshot_blocks``). ``snap[b]`` is
        block b's (slot_keys, values) pair."""
        ids = (list(range(self.spec.num_blocks)) if block_ids is None
               else [int(b) for b in block_ids])
        with self._lock:
            self._check()
            self._before_read()
            st, whole = self._state, block_ids is None
            if isinstance(st, ShardedArray):
                parts = tuple(_snapshot_part(st, ids, whole, i) for i in (0, 1))
            else:
                parts = tuple(_snapshot_part(t, ids, whole) for t in st)
            self._after_read()
            return BlockSnapshot(ids, parts, self.device)

    def export_blocks(self, block_ids: Optional[Sequence[int]] = None
                      ) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
        """Blocks as host (slot_keys, values) pairs, copied under the lock."""
        snap = self.snapshot_blocks(block_ids)
        sk, v = snap.to_host()
        return {b: (sk[i], v[i]) for i, b in enumerate(snap.ids)}

    def import_blocks(self, blocks: Dict[int, Tuple[np.ndarray, np.ndarray]]) -> None:
        """Set whole blocks, slot keys and values, from host payloads (the
        restore path): the slot placement comes back byte for byte."""
        if not blocks:
            return
        ids = sorted(blocks)
        pk = torch.as_tensor(np.stack([np.asarray(blocks[b][0]) for b in ids]))
        pv = torch.as_tensor(np.stack([np.asarray(blocks[b][1]) for b in ids]))
        with self._lock, dispatch_scope(self.mesh):
            self._check()
            self._before_write()
            st = self._state
            for i, (payload, dtype) in enumerate(((pk, torch.int32), (pv, self.spec.dtype))):
                if isinstance(st, ShardedArray):
                    _import_part(st, ids, payload, dtype, i)
                else:
                    _import_part(st[i], ids, payload, dtype)
            self._after_write()

    # -- re-sharding (the migration path) --------------------------------

    def reshard(self, new_mesh: "Mesh | DeviceLike") -> None:
        """Live migration to a new mesh, as ``DenseTable.reshard``: under the
        lock, after every enqueued write and read, the (slot_keys, values)
        pair is rebuilt on the new sharding, both parts block for block, and
        only then do the mesh, sharding and state flip. Bumps the same
        counter as a write (``data_version``), so a serving cache retires
        its rows."""
        self._check()
        self._reshard_storage(new_mesh, "_state")

    def _parts_like(self):
        """The (slot_keys, values) parts, as ((block shape, dtype), ...)."""
        return ((tuple(self.spec.keys_shape[1:]), torch.int32),
                (tuple(self.spec.values_shape[1:]), self.spec.dtype))

    def addressable_blocks(self) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
        """THIS process's owned (slot_keys, values) block pairs, the pod
        checkpoint's stage-1 source (``table.owned_blocks``: both parts
        share the block sharding, so their owners coincide)."""
        with self._lock:
            self._check()
            self._before_read()
            out = owned_blocks(self._state, self.sharding)
            self._after_read()
        return {b: (sk, v) for b, (sk, v) in out.items()}
