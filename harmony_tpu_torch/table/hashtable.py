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

On one device only: ``reshard``, ``export_blocks``, ``import_blocks``,
``addressable_blocks`` and ``snapshot_blocks`` wait for the port of checkpoint
chains and live resharding (ROADMAP A.7, A.10).
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from harmony_tpu_torch.config.params import TableConfig
from harmony_tpu_torch.ops.sparse import gather_rows, segment_sum_rows, value_width
from harmony_tpu_torch.table.update import UpdateFunction, get_update_fn
from harmony_tpu_torch.utils.platform import DeviceLike, resolve_device

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
        return values.view(self.num_slots, self.width)

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
        the keys' init values when the caller has them."""
        slot_keys, values = state
        keys = keys.reshape(-1).to(torch.int32)
        n = keys.shape[0]
        valid = (keys >= MIN_KEY) & (keys <= MAX_KEY)
        enc = _encode_keys(keys)
        block, start, stride = self._route(keys)
        base = block * self.block_slots
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
        fresh = self._one_writer_per_slot(block, safe_slot, fresh)
        if init_v is None:
            init_v = self._init_values(keys)
        flat = self._flat(values)
        lin = base + safe_slot
        self._write_rows(flat, lin, flat[lin] + init_v.reshape(n, self.width), fresh)
        return (slot_keys, values), (block, safe_slot, ok)

    def lookup(self, state: State, keys: torch.Tensor) -> torch.Tensor:
        """Read-only multiGet: values of present keys, init values of absent
        ones; nothing is inserted (``get`` as against ``getOrInit``)."""
        slot_keys, values = state
        keys = keys.reshape(-1).to(torch.int32)
        n = keys.shape[0]
        valid = (keys >= MIN_KEY) & (keys <= MAX_KEY)
        enc = _encode_keys(keys)
        block, start, stride = self._route(keys)
        base = block * self.block_slots
        flat_keys = slot_keys.view(-1)
        slot = torch.full_like(block, -1)
        for r in range(self.max_probes):
            cand = self._probe_slot(start, stride, r)
            hit = valid & (slot < 0) & (flat_keys[base + cand] == enc)
            slot = torch.where(hit, cand, slot)
        found = valid & (slot >= 0)
        got = gather_rows(self._flat(values), (base + slot.clamp_min(0)).to(torch.int32))
        init_v = self._init_values(keys).reshape(n, self.width)
        return torch.where(found[:, None], got, init_v).reshape(n, *self.value_shape)

    def pull(self, state: State, keys: torch.Tensor):
        """getOrInit pull: admit, then read the values at the resolved slots
        through ``gather_rows`` (K1). Returns ``(state, values, token)``; the
        token goes to :meth:`push` for the same keys (no second probe)."""
        keys = keys.reshape(-1).to(torch.int32)
        n = keys.shape[0]
        init_v = self._init_values(keys)
        state, token = self.ensure(state, keys, init_v)
        block, slot, ok = token
        vals = gather_rows(self._flat(state[1]), self._lin(block, slot).to(torch.int32))
        vals = torch.where(ok[:, None], vals, init_v.reshape(n, self.width))
        return state, vals.reshape(n, *self.value_shape), token

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
        block, slot, ok = token
        self._exact_set(self._flat(state[1]), block, slot, ok, values_in)
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
        by an exact set."""
        block, slot, ok = token
        flat = self._flat(state[1])
        deltas = deltas.reshape(ok.shape[0], self.width).to(self.dtype)
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
        return state


class DeviceHashTable:
    """Host-side handle of a hash table on one device: serialised steps and
    commits, the host op surface (multi_get_or_init, multi_get, multi_update,
    multi_put) and the overflow count.

    Keys the table refuses (out of domain, or past the probe budget) are
    counted in :attr:`overflow_count`, never dropped silently: the host ops
    count their own, and a training step's per-batch counts are folded in
    with :meth:`count_dropped` at its epoch's drain."""

    def __init__(self, spec: HashTableSpec, device: DeviceLike = None,
                 state: Optional[State] = None) -> None:
        self.spec = spec
        self.device = resolve_device(device)
        self._lock = threading.RLock()
        if state is None:
            state = spec.init_state(self.device)
        else:
            self._check_state(state)
            state = (state[0].to(self.device, torch.int32).contiguous(),
                     state[1].to(self.device, spec.dtype).contiguous())
        self._state: Optional[State] = state
        self._dropped = False
        self.overflow_count = 0

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
        the same tensors)."""
        with self._lock:
            self._check()
            self._check_state(new_state)
            sk, v = new_state
            if (sk.dtype != torch.int32 or v.dtype != self.spec.dtype
                    or sk.device != self._state[0].device
                    or v.device != self._state[1].device):
                raise ValueError("commit: state dtype or device changed")
            self._state = (sk, v)

    def apply_step(self, step_fn: Callable, *args):
        """Run ``step_fn(state, *args) -> (new_state, out)`` and commit, both
        under the table lock. Returns ``out``."""
        with self._lock:
            self._check()
            new_state, out = step_fn(self._state, *args)
            self.commit(new_state)
        return out

    def apply_step_with(self, local, step_fn: Callable, *extra):
        """Run ``step_fn(state, local_arr, *extra) -> ((new_state, new_local),
        aux)`` and commit both (a hash model table beside a dense worker-local
        table: sparse LDA). Lock order as ``DenseTable.apply_step_with``: this
        table's lock, then ``local``'s."""
        with self._lock, local._lock:
            self._check()
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
        """Read-only lookup: absent keys read as init and are not inserted."""
        k = self._keys(keys)
        with self._lock:
            self._check()
            return self.spec.lookup(self._state, k).cpu().numpy()

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
            return int((self._state[0] < 0).sum())

    def items(self) -> Dict[int, np.ndarray]:
        """Every present (key, value) pair (a test and debug surface)."""
        with self._lock:
            self._check()
            sk = self._state[0].cpu().numpy().reshape(-1)
            v = self._state[1].cpu().numpy().reshape(-1, *self.spec.value_shape)
        return {int(_decode_stored(sk[i])): v[i] for i in np.nonzero(sk < 0)[0]}

    def drop(self) -> None:
        with self._lock:
            self._dropped = True
            self._state = None

    # -- elasticity and checkpoints: not ported yet -------------------------

    def _not_ported(self, what: str):
        raise NotImplementedError(
            f"DeviceHashTable.{what} waits for the port of checkpoint chains and "
            "live resharding (ROADMAP A.7, A.10)")

    def reshard(self, *args, **kwargs) -> None:
        self._not_ported("reshard")

    def export_blocks(self, *args, **kwargs):
        self._not_ported("export_blocks")

    def import_blocks(self, *args, **kwargs) -> None:
        self._not_ported("import_blocks")

    def addressable_blocks(self, *args, **kwargs):
        self._not_ported("addressable_blocks")

    def snapshot_blocks(self, *args, **kwargs):
        self._not_ported("snapshot_blocks")
