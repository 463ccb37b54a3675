"""Checkpoint engines (counterpart of
``deepspeed_tpu/runtime/checkpoint_engine.py``; reference:
runtime/checkpoint_engine/checkpoint_engine.py:9 — CheckpointEngine ABC with
create/save/load/commit; TorchCheckpointEngine and the async
NebulaCheckpointEngine).

The JAX engines write orbax directories; the port writes its own files
under the same ``<save_dir>/<tag>/state/``: one safetensors file a rank,
``rank{r}.safetensors`` (this rank's tensors, written by
``checkpoint/huggingface.py``'s writer, read back through its reader with
the bits and dtypes as saved), and ``index.json``, the layout: for every
entry its full shape, its dtype and the dim its ranks split it on (None:
whole, in rank 0's file only) with the number of pieces and the rank
whose file holds each (an index without them, as the first checkpoints
of this format wrote: the world size's pieces in the files of ranks 0,
1, ...). ``load`` gives a
:class:`ShardedCheckpoint`, which assembles any entry in full or cuts it
for another world size and split dim, so a checkpoint written at one ZeRO
stage and W loads at another.

:class:`SafetensorsCheckpointEngine` saves synchronously (the
TorchCheckpointEngine analogue). :class:`AsyncCheckpointEngine` returns
once the device tensors are copied into a host buffer (pinned, on the
card: non-blocking copies and one event wait) and writes the file on a
thread; ``commit()`` or the next ``save`` waits for that write, and only
then is ``latest`` written, so ``latest`` never names a partial
checkpoint. Across ranks ``latest`` is written by rank 0 after a barrier,
once every rank's file is written.
"""

from __future__ import annotations

import glob
import json
import os
import threading
from typing import Optional

import torch

from ..comm import comm
from ..utils.logging import log_dist

LATEST_FILE = "latest"
INDEX_FILE = "index.json"
FORMAT = "deepspeed_tpu_torch"
_HOST_ALIGN = 64                # bytes: every tensor of a snapshot
MEMORY_TIERS = ("ROADMAP: port Queue 1, Slice E (memory tiers: "
                "runtime/offload.py, runtime/infinity.py)")


def checkpoint_dtypes() -> dict:
    """The safetensors dtypes of the state files: the HF reader's and
    int32 (the step counters)."""
    from ..checkpoint.huggingface import SAFETENSORS_DTYPES
    return dict(SAFETENSORS_DTYPES, I32=torch.int32)


def rank_file(rank: int) -> str:
    return f"rank{rank}.safetensors"


def check_tag_dir(path: str) -> None:
    """Refuse a tag directory of the JAX memory tiers: its optimizer state
    lives in ``host_opt_rank*.npz`` files the port cannot produce or
    restore yet."""
    if glob.glob(os.path.join(path, "host_opt_rank*.npz")):
        raise NotImplementedError(
            f"{path!r} holds host_opt_rank*.npz, the host optimizer state "
            f"of the JAX package's NVMe/CPU offload; the memory tiers are "
            f"not ported yet ({MEMORY_TIERS})")


class ShardedCheckpoint:
    """The ``state/`` directory of one checkpoint: its index and each
    rank's file, opened lazily (every tensor mapped from its file only
    when read)."""

    def __init__(self, path: str):
        index = os.path.join(path, INDEX_FILE)
        if not os.path.exists(index):
            raise FileNotFoundError(
                f"{path!r} holds no {INDEX_FILE}: not a checkpoint of "
                f"deepspeed_tpu_torch (the JAX package's orbax directories "
                f"are read through its ds_to_universal output, "
                f"load_universal)")
        with open(index) as f:
            self.index = json.load(f)
        if self.index.get("format") != FORMAT:
            raise ValueError(f"{index!r}: format "
                             f"{self.index.get('format')!r}, not {FORMAT!r}")
        self.path = path
        self.world = int(self.index["world"])
        self.entries: dict[str, dict] = self.index["entries"]
        self._files: dict[int, object] = {}

    def _file(self, rank: int):
        from ..checkpoint.huggingface import SafetensorsFile
        if rank not in self._files:
            self._files[rank] = SafetensorsFile(
                os.path.join(self.path, rank_file(rank)), checkpoint_dtypes())
        return self._files[rank]

    def keys(self) -> list[str]:
        return list(self.entries)

    def __contains__(self, key: str) -> bool:
        return key in self.entries

    def files(self, key: str) -> list[int]:
        """The ranks whose files hold the entry's pieces, in order."""
        entry = self.entries[key]
        if entry["dim"] is None:
            return [0]
        return entry.get("ranks", list(range(entry.get("world",
                                                       self.world))))

    def full(self, key: str) -> torch.Tensor:
        """The whole entry (CPU), its pieces concatenated along the dim
        they were split on."""
        files = self.files(key)
        if len(files) == 1:
            return self._file(files[0]).get(key)
        return torch.cat([self._file(r).get(key) for r in files],
                         self.entries[key]["dim"])

    def piece(self, key: str, world: int, rank: int,
              dim: Optional[int]) -> torch.Tensor:
        """Piece ``rank`` of the entry when ``world`` ranks split it on
        ``dim`` (None: the whole entry): read from its file where the
        layout is the saved one, else cut from the whole."""
        saved = self.entries[key]["dim"]
        if dim is None:
            return self.full(key)
        files = self.files(key)
        if saved == dim and world == len(files):
            return self._file(files[rank]).get(key)
        return self.full(key).chunk(world, dim)[rank]


def _snapshot(tensors: dict, holder: dict, pinned: bool
              ) -> dict[str, torch.Tensor]:
    """Copies of ``tensors`` in one host buffer (kept in ``holder`` and
    reused while large enough): pinned and filled by non-blocking copies
    and one event wait where a tensor lies on the card."""
    offsets, total = [], 0
    for t in tensors.values():
        offsets.append(total)
        n = t.numel() * t.element_size()
        total += -(-n // _HOST_ALIGN) * _HOST_ALIGN
    buf = holder.get("buffer")
    if buf is None or buf.numel() < total or buf.is_pinned() != pinned:
        holder["buffer"] = None
        buf = torch.empty(max(total, 1), dtype=torch.uint8,
                          pin_memory=pinned)
        holder["buffer"] = buf
    out = {}
    for (name, t), off in zip(tensors.items(), offsets):
        n = t.numel() * t.element_size()
        host = buf[off:off + n].view(t.dtype).view(t.shape)
        host.copy_(t, non_blocking=pinned)
        out[name] = host
    if pinned:
        event = torch.cuda.Event()
        event.record()
        event.synchronize()
    return out


class CheckpointEngine:
    """reference: runtime/checkpoint_engine/checkpoint_engine.py:9.
    ``group`` is the data-parallel group whose rank 0 writes ``latest``."""

    def __init__(self, config_params=None, group=None):
        self.config = config_params
        self.group = group
        self._pending_latest: Optional[tuple[str, str]] = None
        self._host: dict = {}

    def create(self, tag: str) -> None:
        """Log the start of a new checkpoint (reference: create)."""
        log_dist(f"[ckpt] saving checkpoint {tag}")

    def register_latest(self, save_dir: str, tag: str) -> None:
        """Point ``<save_dir>/latest`` at ``tag``. Sync engines write it
        now (every rank's file is written); async engines defer it to
        commit() or the next save, so ``latest`` never names a partial
        checkpoint."""
        self._write_latest(save_dir, tag)

    def _write_latest(self, save_dir: str, tag: str) -> None:
        comm.barrier(self.group)
        if comm.get_rank(self.group) == 0:
            tmp = os.path.join(save_dir, LATEST_FILE + ".tmp")
            with open(tmp, "w") as f:
                f.write(tag)
            os.replace(tmp, os.path.join(save_dir, LATEST_FILE))

    def _flush_latest(self) -> None:
        if self._pending_latest is not None:
            pending, self._pending_latest = self._pending_latest, None
            self._write_latest(*pending)

    def save(self, tensors: dict, path: str,
             metadata: Optional[dict] = None) -> None:
        """Write ``tensors`` (name -> tensor, any device) as the
        safetensors file ``path``."""
        raise NotImplementedError

    def load(self, path: str) -> ShardedCheckpoint:
        """The ``state/`` directory ``path``, every rank's file."""
        return ShardedCheckpoint(path)

    def commit(self, tag: str) -> bool:
        """Mark the checkpoint durable; blocks for async engines."""
        return True

    def makedirs(self, path: str, exist_ok: bool = True) -> None:
        os.makedirs(path, exist_ok=exist_ok)

    def _host_copy(self, tensors: dict) -> dict[str, torch.Tensor]:
        on_card = any(t.device.type == "cuda" for t in tensors.values())
        return _snapshot(tensors, self._host, pinned=on_card)


def _write(host: dict, path: str, metadata: Optional[dict]) -> int:
    from ..checkpoint.huggingface import save_safetensors
    tmp = path + ".tmp"
    n = save_safetensors(host, tmp, metadata, checkpoint_dtypes())
    os.replace(tmp, path)
    return n


class SafetensorsCheckpointEngine(CheckpointEngine):
    """Synchronous save (the TorchCheckpointEngine analogue): the tensors
    copied to the host, then written before ``save`` returns. A tensor
    already on the CPU is written as it is."""

    def save(self, tensors: dict, path: str,
             metadata: Optional[dict] = None) -> None:
        if any(t.device.type != "cpu" for t in tensors.values()):
            tensors = self._host_copy(tensors)
        _write(tensors, path, metadata)


class AsyncCheckpointEngine(CheckpointEngine):
    """Background-written save (NebulaCheckpointEngine analogue,
    reference runtime/checkpoint_engine/nebula_checkpoint_engine.py).

    ``save`` returns once the tensors are copied into the host buffer; a
    thread writes the file. ``commit`` (or the next save) waits for that
    write, raises what it raised, and then writes the deferred ``latest``.
    """

    def __init__(self, config_params=None, group=None):
        super().__init__(config_params, group)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise RuntimeError("the background checkpoint write "
                               "failed") from error

    def save(self, tensors: dict, path: str,
             metadata: Optional[dict] = None) -> None:
        # one write in flight: the previous one is then durable, and its
        # deferred latest pointer can be written
        self._wait()
        self._flush_latest()
        host = self._host_copy(tensors)

        def run():
            try:
                _write(host, path, metadata)
            except BaseException as e:   # raised by the next wait
                self._error = e

        self._thread = threading.Thread(target=run, name="ckpt-writer",
                                        daemon=True)
        self._thread.start()

    def register_latest(self, save_dir: str, tag: str) -> None:
        self._pending_latest = (save_dir, tag)

    def load(self, path: str) -> ShardedCheckpoint:
        self._wait()
        return super().load(path)

    def commit(self, tag: str) -> bool:
        self._wait()
        self._flush_latest()
        log_dist(f"[ckpt] checkpoint {tag} committed")
        return True


def build_checkpoint_engine(config, group=None) -> CheckpointEngine:
    """Select the engine from config (reference: engine.py
    _configure_checkpointing:975 — Nebula if enabled, else Torch)."""
    ckpt_cfg = getattr(config, "checkpoint", None)
    if ckpt_cfg is not None and getattr(ckpt_cfg, "async_save", False):
        return AsyncCheckpointEngine(config, group)
    return SafetensorsCheckpointEngine(config, group)
