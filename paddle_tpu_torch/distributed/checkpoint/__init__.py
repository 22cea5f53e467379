"""The sharded checkpoint — the counterpart of
``paddle_tpu/distributed/checkpoint/__init__.py`` (Paddle
``checkpoint/save_state_dict.py:135``, ``load_state_dict.py``).

The on-disk format is the JAX package's, so either package reads what the
other wrote: under ``path``, each rank's chunks in ``data_r{rank}.npz``
(entry ``"{key}/{i}"``), its list in the sidecar ``meta_r{rank}.json``,
and ``metadata.json``: ``{"version": 1, "keys": {key: {"kind": "tensor",
"shape", "dtype", "chunks": [{"offset", "shape", "file", "key"}]}}}``,
or ``{"kind": "scalar", "value"}`` for a number, string, bool or None.
bf16 is stored as its 16-bit view beside the dtype name (``np_dtype``,
``storable_view``, ``readback_view``: the port's own copies, over torch
tensors, with no ``ml_dtypes``).

A JAX array knows its shards; a rank's tensor here knows where it sits
through ``distributed.layout`` (the tensor-parallel layers, the ZeRO
stages and the pipeline stages attach it where they cut the part; a
tensor without one is whole). Saving: every rank lists its pieces, the
lists are exchanged (one ``all_gather_object``), and each global region is
written by the lowest rank that holds it (dedup: one replica writes);
then a barrier, and the coordinator collates the sidecars into
``metadata.json`` (JAX polls for them, :172). ``async_save=True`` copies
to the host at once, writes on a thread, and returns a handle whose
``.result()`` joins it (the coordinator's thread waits for the sidecars).
Loading copies into every tensor of ``state_dict`` in place, each rank
reading only the chunks that meet its own pieces: any layout to any
layout (mesh change, ZeRO stage, tensor or pipeline parallel degree).
"""
from __future__ import annotations

import glob
import json
import os
import threading
import time

import numpy as np
import torch

from .. import env

__all__ = ["save_state_dict", "load_state_dict", "np_dtype",
           "storable_view", "readback_view", "ChunkReader"]

_META_NAME = "metadata.json"

_NAMES = {torch.float32: "float32", torch.float64: "float64",
          torch.float16: "float16", torch.bfloat16: "bfloat16",
          torch.int64: "int64", torch.int32: "int32", torch.int16: "int16",
          torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool"}
_TORCH = {v: k for k, v in _NAMES.items()}
# dtypes numpy has no type for: stored as the unsigned view of their size
_EXTENSION = {"bfloat16": np.uint16, "float8_e4m3fn": np.uint8,
              "float8_e5m2": np.uint8}


def np_dtype(name):
    """The numpy dtype a checkpoint's chunks of dtype ``name`` are stored
    in (an extension dtype's unsigned view of the same size)."""
    if name in _EXTENSION:
        return np.dtype(_EXTENSION[name])
    return np.dtype(name)


def storable_view(t):
    """A numpy array of ``t``'s bytes that ``np.save`` round-trips: bf16 as
    uint16 (numpy has no bf16; JAX stores its ml_dtypes arrays so)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(np.uint16)
    return t.contiguous().numpy()


def readback_view(data, want):
    """The reverse of ``storable_view``: a stored chunk as a torch tensor
    of dtype name ``want``."""
    if want in _EXTENSION and data.dtype.kind == "u":
        if want != "bfloat16":
            raise NotImplementedError(f"dtype {want} has no torch "
                                      f"counterpart here")
        return torch.from_numpy(np.ascontiguousarray(data).view(
            np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(data))


def _dtype_name(t):
    if t.dtype not in _NAMES:
        raise TypeError(f"checkpoint: no stored form for {t.dtype}")
    return _NAMES[t.dtype]


def _value_of(x):
    return x._value if hasattr(x, "_value") else x


def _flatten(state_dict, prefix=""):
    flat = {}
    for k, v in state_dict.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(_flatten(v, prefix=f"{name}."))
        else:
            flat[name] = v
    return flat


def _is_scalar(v):
    if isinstance(v, (int, float, str, bool)) or v is None:
        return True
    return isinstance(v, (list, tuple)) and all(_is_scalar(x) for x in v)


def _rank_world():
    if env.is_initialized():
        return env.get_rank(), env.get_world_size()
    return 0, 1


def _pieces(name, val):
    """[(global offset, local slices, piece shape)] and the global shape of
    a tensor value."""
    from ..layout import layout_of

    shape, pieces = layout_of(val)
    out = []
    for sl, off in pieces:
        pshape = [s.stop - s.start for s in sl]
        out.append((list(off), sl, pshape))
    return shape, out


def save_state_dict(state_dict, path, process_group=None, coordinator_rank=0,
                    async_save=False):
    """Save a (possibly nested) state dict of tensors (each this rank's
    part, with its layout), numpy arrays (written whole by the
    coordinator) and scalars under ``path``; returns ``path``, or a handle
    with ``.result()`` under ``async_save``."""
    rank, world = _rank_world()
    os.makedirs(path, exist_ok=True)
    flat = _flatten(state_dict)
    meta_keys, held = {}, {}
    for name, v in flat.items():
        val = _value_of(v)
        if _is_scalar(val):
            meta_keys[name] = {"kind": "scalar", "value": (
                list(val) if isinstance(val, tuple) else val)}
            continue
        if isinstance(val, np.ndarray) or np.isscalar(val):
            val = torch.from_numpy(np.array(val))
            if rank != coordinator_rank:
                meta_keys[name] = {"kind": "tensor",
                                   "shape": list(val.shape),
                                   "dtype": _dtype_name(val), "chunks": []}
                continue
        shape, pieces = _pieces(name, val)
        meta_keys[name] = {"kind": "tensor", "shape": shape,
                           "dtype": _dtype_name(val), "chunks": []}
        held[name] = (val, pieces)
    mine = sorted((n, tuple(off)) for n, (_, ps) in held.items()
                  for off, _, _ in ps)
    if world > 1:
        lists = [None] * world
        torch.distributed.all_gather_object(lists, mine)
    else:
        lists = [mine]
    writer = {}
    for r, lst in enumerate(lists):
        for item in lst:
            writer.setdefault(tuple(item), r)
    fname = f"data_r{rank}.npz"
    chunks = {}
    for name, (val, pieces) in held.items():
        entry = meta_keys[name]
        for off, sl, pshape in pieces:
            if writer[(name, tuple(off))] != rank:
                continue
            cname = f"{name}/{len(entry['chunks'])}"
            chunks[cname] = storable_view(val[sl])
            entry["chunks"].append({"offset": off, "shape": pshape,
                                    "file": fname, "key": cname})

    def write_files():
        if chunks:
            np.savez(os.path.join(path, fname), **chunks)
        sidecar = os.path.join(path, f"meta_r{rank}.json")
        with open(sidecar + ".tmp", "w") as f:
            json.dump(meta_keys, f)
        os.replace(sidecar + ".tmp", sidecar)

    if async_save:
        def run():
            write_files()
            if rank == coordinator_rank:
                _collate_metadata(path, wait_world=world)

        t = threading.Thread(target=run, daemon=True)
        t.start()

        class _Handle:
            def result(self, timeout=None):
                t.join(timeout)
                return path

        return _Handle()
    write_files()
    if world > 1:
        torch.distributed.barrier()
    if rank == coordinator_rank:
        _collate_metadata(path)
    if world > 1:
        torch.distributed.barrier()
    return path


def _collate_metadata(path, wait_world=None, timeout=60.0):
    """Merge the ranks' sidecars into metadata.json (the coordinator);
    with ``wait_world``, first wait for that many sidecars."""
    deadline = time.monotonic() + timeout
    while True:
        sidecars = sorted(glob.glob(os.path.join(path, "meta_r*.json")))
        if wait_world is None or len(sidecars) >= wait_world:
            break
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"checkpoint collation: {len(sidecars)}/{wait_world} rank "
                f"sidecars appeared within {timeout}s")
        time.sleep(0.05)
    merged = {}
    for sc in sidecars:
        with open(sc) as f:
            part = json.load(f)
        for name, entry in part.items():
            if name not in merged:
                merged[name] = entry
            elif entry.get("kind") == "tensor":
                have = {tuple(c["offset"]) for c in merged[name]["chunks"]}
                for c in entry["chunks"]:
                    if tuple(c["offset"]) not in have:
                        merged[name]["chunks"].append(c)
    with open(os.path.join(path, _META_NAME) + ".tmp", "w") as f:
        json.dump({"version": 1, "keys": merged}, f)
    os.replace(os.path.join(path, _META_NAME) + ".tmp",
               os.path.join(path, _META_NAME))


class ChunkReader:
    """Lazily opened npz files; ``read`` assembles a global region from
    the chunks that meet it (JAX's reader, over stored numpy views)."""

    def __init__(self, path):
        self.path = path
        self._files = {}

    def file(self, fname):
        if fname not in self._files:
            self._files[fname] = np.load(os.path.join(self.path, fname))
        return self._files[fname]

    def read(self, entry, offset, out_shape):
        """The region ``[offset, offset + out_shape)`` of a metadata entry,
        as a torch tensor of its dtype; every element must be covered."""
        out = np.empty(out_shape, dtype=np_dtype(entry["dtype"]))
        filled = np.zeros(out_shape, dtype=bool)
        for c in entry["chunks"]:
            c_off, c_shape = c["offset"], c["shape"]
            lo = [max(o, co) for o, co in zip(offset, c_off)]
            hi = [min(o + s, co + cs) for o, s, co, cs in
                  zip(offset, out_shape, c_off, c_shape)]
            if any(a >= b for a, b in zip(lo, hi)):
                continue
            src = tuple(slice(a - co, b - co) for a, b, co in
                        zip(lo, hi, c_off))
            dst = tuple(slice(a - o, b - o) for a, b, o in zip(lo, hi, offset))
            data = self.file(c["file"])[c["key"]]
            out[dst] = data[src].view(out.dtype) if (
                data.dtype != out.dtype and data.dtype.itemsize
                == out.dtype.itemsize) else data[src]
            filled[dst] = True
        if not filled.all():
            raise ValueError("saved chunks do not cover the requested region "
                             f"(shape {entry['shape']}, offset {offset}, "
                             f"size {out_shape})")
        return readback_view(out, entry["dtype"])

    def close(self):
        for f in self._files.values():
            f.close()
        self._files = {}


def load_state_dict(state_dict, path, process_group=None, coordinator_rank=0):
    """Restore ``state_dict`` in place from ``path``: every tensor keeps
    its layout (which may differ from the one it was saved under) and
    reads only the regions its pieces cover; scalars are replaced."""
    with open(os.path.join(path, _META_NAME)) as f:
        meta = json.load(f)["keys"]
    reader = ChunkReader(path)
    try:
        _load_into(state_dict, meta, reader, "")
    finally:
        reader.close()
    return state_dict


@torch.no_grad()
def _load_into(state_dict, meta, reader, prefix):
    for k, v in state_dict.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            _load_into(v, meta, reader, f"{name}.")
            continue
        if name not in meta:
            raise KeyError(f"checkpoint at hand has no entry for {name!r}")
        entry = meta[name]
        if entry["kind"] == "scalar":
            state_dict[k] = entry["value"]
            continue
        val = _value_of(v)
        if isinstance(val, np.ndarray) or not isinstance(val, torch.Tensor):
            full = reader.read(entry, [0] * len(entry["shape"]),
                               entry["shape"])
            state_dict[k] = full.numpy() if isinstance(
                val, np.ndarray) else full
            continue
        shape, pieces = _pieces(name, val)
        if list(shape) != list(entry["shape"]):
            raise ValueError(f"{name}: checkpoint shape {entry['shape']} != "
                             f"target {shape}")
        for off, sl, pshape in pieces:
            part = reader.read(entry, off, pshape)
            val[sl].copy_(part.to(val.dtype))
