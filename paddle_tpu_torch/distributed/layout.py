"""Where a rank's part of a tensor sits in the global tensor.

The JAX package's arrays are global and know their layout
(``addressable_shards``). A rank of the port holds a part, so the code
that cuts the part says where it sits, on the torch tensor itself:

* ``_global_shape``: the whole tensor's shape;
* ``_global_pieces``: a list of ``(local_slices, global_offset)``: the
  local region ``local_slices`` (a tuple of slices) is the global region
  of the same shape that starts at ``global_offset``. A contiguous part is
  one piece; a fused weight cut per head group (GPT's ``qkv_proj`` under
  tensor parallelism) is several.

The tensor-parallel layers (``fleet.meta_parallel``), the ZeRO stages
(``sharding``) and the pipeline's stage parameters (whole: one piece at
the origin) attach it where they make the part; the sharded checkpoint
(``checkpoint``) writes and reads the pieces.
"""
from __future__ import annotations

import weakref

__all__ = ["set_layout", "cut", "cut_pieces", "layout_of"]

# the tensors with a layout (id -> tensor), and an index of them by
# (storage address, offset, shape, strides), so a detached view of one
# (``Module.state_dict()``) finds it too. A tensor's data may be replaced
# after its layout was set (``p.data = ...``: ``amp.decorate`` O2,
# ``Module.to``): a miss indexes them anew from their storages now.
_HELD = weakref.WeakValueDictionary()
_BY_STORAGE = weakref.WeakValueDictionary()


def _storage_key(t):
    try:
        return (t.untyped_storage().data_ptr(), t.storage_offset(),
                tuple(t.shape), tuple(t.stride()))
    except (AttributeError, RuntimeError):
        return None


def _holder(key):
    held = _BY_STORAGE.get(key)
    if held is not None and _storage_key(held) == key:
        return held
    _BY_STORAGE.clear()
    for t in list(_HELD.values()):
        k = _storage_key(t)
        if k is not None:
            _BY_STORAGE[k] = t
    return _BY_STORAGE.get(key)


def _whole(shape):
    return [(tuple(slice(0, s) for s in shape), [0] * len(shape))]


def set_layout(t, global_shape, pieces=None):
    """Attach the global shape and the pieces (default: ``t`` is the whole
    tensor)."""
    t._global_shape = [int(s) for s in global_shape]
    t._global_pieces = (_whole(t.shape) if pieces is None else
                        [(tuple(sl), [int(o) for o in off])
                         for sl, off in pieces])
    _HELD[id(t)] = t
    key = _storage_key(t)
    if key is not None:
        _BY_STORAGE[key] = t
    return t


def layout_of(t):
    """(global shape, pieces) of ``t``; a tensor without one is whole."""
    shape = getattr(t, "_global_shape", None)
    if shape is None:
        key = _storage_key(t)
        held = _holder(key) if key is not None else None
        if held is None:
            return [int(s) for s in t.shape], _whole(t.shape)
        t = held
        shape = t._global_shape
    return list(shape), list(t._global_pieces)


def cut(t, dim, parts, index):
    """``t``'s layout after it is cut into ``parts`` equal parts along
    local dimension ``dim`` and part ``index`` kept: returns the kept
    part's pieces (for ``set_layout`` on the part)."""
    return cut_pieces(list(t.shape), layout_of(t)[1], dim, parts, index)


def cut_pieces(shape, pieces, dim, parts, index):
    """``cut`` over a local ``shape`` and its ``pieces``."""
    size = shape[dim] // parts
    lo, hi = index * size, (index + 1) * size
    out = []
    for sl, off in pieces:
        a, b = sl[dim].start, sl[dim].stop
        a2, b2 = max(a, lo), min(b, hi)
        if a2 >= b2:
            continue
        sl2 = list(sl)
        sl2[dim] = slice(a2 - lo, b2 - lo)
        off2 = list(off)
        off2[dim] = off[dim] + (a2 - a)
        out.append((tuple(sl2), off2))
    return out
