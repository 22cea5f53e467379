"""``InMemoryDataset`` / ``QueueDataset`` — the counterpart of
``paddle_tpu/distributed/fleet_dataset.py`` (Paddle
``distributed/fleet/dataset/dataset.py``), as it is.

Host-side file feeding, without the parameter-server runtime: the
datasets read local text files (optionally through a ``pipe_command``
filter, streamed line by line; an empty filter result is no error, a
failing command raises), hold or stream the samples, shuffle, and iterate
like any ``io.IterableDataset``, so ``io.DataLoader`` drives them into
collective training. ``global_shuffle`` applies the same permutation on
every rank: its seed comes from the framework generator, the same on
every rank after ``paddle.seed``, and moves on as the generator is used.
"""
from __future__ import annotations

import subprocess

import numpy as np

from ..io import IterableDataset


class DatasetBase(IterableDataset):
    def __init__(self):
        self._filelist: list[str] = []
        self._pipe_command = None
        self._batch_size = 1
        self._thread_num = 1
        self._use_var_names: list[str] = []
        self._parse_fn = None

    def init(self, batch_size=1, thread_num=1, use_var=None, pipe_command=None,
             input_type=0, fs_name="", fs_ugi="", download_cmd="cat", **kw):
        self._batch_size = batch_size
        self._thread_num = thread_num
        self._pipe_command = pipe_command
        self._use_var_names = [getattr(v, "name", str(v))
                               for v in (use_var or [])]
        return self

    def set_filelist(self, filelist):
        self._filelist = list(filelist)

    def set_parse_fn(self, fn):
        """TPU extension: how a text line becomes a sample. Default: split on
        whitespace into a float32 vector."""
        self._parse_fn = fn

    def _parse(self, line):
        if self._parse_fn is not None:
            return self._parse_fn(line)
        return np.asarray([float(v) for v in line.split()], np.float32)

    def _read_file(self, path):
        if self._pipe_command:
            # line-streamed (a multi-GB log must not materialize whole);
            # empty filter output is a valid result, not an error (grep
            # exits 1 on no match) — only command failure (rc > 1) raises
            with open(path, "rb") as src:
                proc = subprocess.Popen(self._pipe_command, shell=True,
                                        stdin=src, stdout=subprocess.PIPE)
                try:
                    for raw in proc.stdout:
                        line = raw.decode("utf-8", "ignore")
                        if line.strip():
                            yield self._parse(line)
                finally:
                    proc.stdout.close()
                    rc = proc.wait()
            if rc not in (0, 1):
                raise RuntimeError(
                    f"pipe_command {self._pipe_command!r} failed rc={rc}")
        else:
            with open(path, "r") as f:
                for line in f:
                    if line.strip():
                        yield self._parse(line)


class QueueDataset(DatasetBase):
    """Reference dataset.py QueueDataset — streaming: samples are read from
    the filelist on the fly, never all resident."""

    def __iter__(self):
        for path in self._filelist:
            yield from self._read_file(path)


class InMemoryDataset(DatasetBase):
    """Reference dataset.py InMemoryDataset — load_into_memory +
    local/global shuffle + release_memory lifecycle."""

    def __init__(self):
        super().__init__()
        self._samples: list = []
        self._loaded = False

    def load_into_memory(self):
        self._samples = []
        for path in self._filelist:
            self._samples.extend(self._read_file(path))
        self._loaded = True

    def preload_into_memory(self, thread_num=None):
        self.load_into_memory()

    def wait_preload_done(self):
        pass

    def local_shuffle(self):
        np.random.shuffle(self._samples)

    def global_shuffle(self, fleet=None, thread_num=12):
        """Every process holds the full list, so a global shuffle is the
        same permutation on every rank, seeded from the framework
        generator's state (numpy's global generator would not be aligned
        across ranks); the generator advances, so the next epoch's
        permutation is another."""
        import torch

        from ..framework import random as _rng

        gen = _rng.default_generator("cpu")
        seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=gen))
        np.random.RandomState(seed).shuffle(self._samples)

    def get_memory_data_size(self, fleet=None):
        return len(self._samples)

    def get_shuffle_data_size(self, fleet=None):
        return len(self._samples)

    def release_memory(self):
        self._samples = []
        self._loaded = False

    def __iter__(self):
        if not self._loaded:
            raise RuntimeError("call load_into_memory() after set_filelist()")
        return iter(self._samples)

    def __len__(self):
        return len(self._samples)
