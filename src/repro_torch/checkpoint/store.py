"""Sharded checkpointing with torrent-style restore.

Layout:
  <root>/step_<n>/manifest.json       tree structure, shapes, dtypes, pieces
  <root>/step_<n>/piece_<i>.npz       flat-chunked payload pieces
  <root>/step_<n>/COMMITTED           write barrier marker

Pieces (not per-tensor files) are the unit of both I/O and swarm exchange:
replicas receive them host-side through the swarm (core/swarm's
rarest-first plan) or, inside a pod, over the torrent ring of
`parallel/weight_torrent.py` (`restore_distributed`).  `async_save` runs
serialisation off-thread so the train loop never blocks (the step's
arrays are snapshotted to host first).

Every committed step also carries `swarm.json`: a `PieceManifest` (the
torrent metainfo) over the step's canonical *image* — manifest.json plus
the piece files packed into one byte stream by `pack_step_image` — so a
checkpoint can be advertised to the volunteer swarm as a regular
piece-wise Application and serving replicas can cold-start from peers
(`checkpoint/swarm_restore.py`) instead of hammering this store.

Counterpart of `repro.checkpoint.store`, on nested dicts of tensors (it
saves numpy arrays too).  Leaves are taken in sorted-key order, the order in which
jax flattens dicts, and keyed by their path joined with "/", so the same
f32 / int32 tree gives byte-identical pieces, `manifest.json` and
`swarm.json` in both packages, and a step saved by either restores in the
other.  bf16 leaves are written as the reference writes an ml_dtypes
bfloat16 array: raw 16-bit words (npy type ``V2``) under the manifest
dtype ``"bfloat16"``, and are read back as such.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.swarm_arrays import resolve_device
from repro_torch.core.workunit import PieceManifest
from repro_torch.parallel.sharding import ParamSpec, tree_leaves_with_path

# canonical step-image framing: magic + json file table + file bytes
IMAGE_MAGIC = b"CKPTIMG1\n"


def _image_files(d: str) -> List[str]:
    """Canonical file order for a step's swarm image: the tree manifest
    first, then the payload pieces (COMMITTED and swarm.json are framing,
    not content, and stay out of the image)."""
    pieces = sorted(fn for fn in os.listdir(d)
                    if fn.startswith("piece_") and fn.endswith(".npz"))
    return ["manifest.json"] + pieces


def pack_step_image(d: str) -> bytes:
    """Pack a committed step directory into the canonical image bytes the
    swarm manifest hashes: magic, a json file table, then the files'
    bytes concatenated in table order."""
    files = _image_files(d)
    blobs = []
    table = []
    for fn in files:
        with open(os.path.join(d, fn), "rb") as f:
            b = f.read()
        table.append({"name": fn, "size": len(b)})
        blobs.append(b)
    header = json.dumps({"files": table}, sort_keys=True).encode() + b"\n"
    return IMAGE_MAGIC + header + b"".join(blobs)


def unpack_step_image(image, dest_dir: str) -> List[str]:
    """Inverse of `pack_step_image`: write the step's files into
    `dest_dir` (plus a fresh COMMITTED marker) and return the file names.
    Callers verify the image against its PieceManifest *before* calling
    this — the framing here is trusted only after the content re-hash."""
    mv = memoryview(image)
    if bytes(mv[:len(IMAGE_MAGIC)]) != IMAGE_MAGIC:
        raise ValueError("not a checkpoint step image (bad magic)")
    ofs = len(IMAGE_MAGIC)
    end = ofs
    while end < len(mv) and mv[end] != 0x0A:        # newline-terminated
        end += 1
    header = json.loads(bytes(mv[ofs:end]).decode())
    ofs = end + 1
    os.makedirs(dest_dir, exist_ok=True)
    names = []
    for ent in header["files"]:
        n = int(ent["size"])
        with open(os.path.join(dest_dir, ent["name"]), "wb") as f:
            f.write(mv[ofs:ofs + n])
        ofs += n
        names.append(ent["name"])
    if ofs != len(mv):
        raise ValueError("trailing bytes after the declared file table")
    with open(os.path.join(dest_dir, "COMMITTED"), "w") as f:
        f.write(str(time.time()))
    return names


BF16 = "bfloat16"


def _flatten_with_paths(tree) -> List[Tuple[str, Any]]:
    return list(tree_leaves_with_path(tree, sep="/"))


def _host_array(leaf) -> Tuple[np.ndarray, str]:
    """(numpy array to write, manifest dtype) of a leaf.  A CPU tensor's
    array aliases its storage: `async_save` snapshots first."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2")), BF16
        return t.numpy(), str(t.dtype).replace("torch.", "")
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _host_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A loaded leaf as a CPU tensor; ``V2`` words under "bfloat16" are
    viewed as torch.bfloat16."""
    if dtype == BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _restore_leaf(key: str, arr: np.ndarray, dtype: str, want, device):
    """``arr`` as a tensor shaped after the template leaf ``want``: a
    tensor (its device and dtype) or a `ParamSpec` (``device``, its
    dtype)."""
    if not isinstance(want, (torch.Tensor, ParamSpec)):
        raise TypeError(f"template leaf {key}: expected a tensor or a "
                        f"ParamSpec, got {type(want).__name__}")
    shape = tuple(want.shape)
    if tuple(arr.shape) != shape:
        raise ValueError(f"checkpoint leaf {key} has shape "
                         f"{tuple(arr.shape)}, the template {shape}")
    dev = (want.device if isinstance(want, torch.Tensor)
           else resolve_device(device))
    return _host_tensor(arr, dtype).to(device=dev, dtype=want.dtype)


def _rebuild(template, fn, prefix: str = ""):
    if isinstance(template, dict):
        return {k: _rebuild(v, fn, f"{prefix}/{k}" if prefix else str(k))
                for k, v in template.items()}
    return fn(prefix, template)


class CheckpointStore:
    def __init__(self, root: str, piece_bytes: int = 64 << 20,
                 keep_last: int = 3, swarm_piece_bytes: int = 4 << 20):
        self.root = root
        self.piece_bytes = piece_bytes
        self.keep_last = keep_last
        # granularity of the *swarm* manifest over the packed step image;
        # smaller than the I/O piece size so a flash crowd of replicas
        # disperses across many holders instead of queueing on whole shards
        self.swarm_piece_bytes = swarm_piece_bytes
        os.makedirs(root, exist_ok=True)

    def step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:08d}")

    # ------------------------------------------------------------------ #
    def save(self, step: int, tree, extra: Optional[dict] = None) -> str:
        d = os.path.join(self.root, f"step_{step:08d}")
        tmp = d + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        entries = _flatten_with_paths(tree)
        manifest = {"step": step, "extra": extra or {}, "leaves": [],
                    "pieces": []}
        # pack leaves into pieces
        piece, piece_sz, piece_idx = {}, 0, 0
        for key, leaf in entries:
            arr, dtype = _host_array(leaf)
            manifest["leaves"].append({
                "key": key, "shape": list(arr.shape), "dtype": dtype,
                "piece": piece_idx, "name": f"a{len(piece)}"})
            piece[f"a{len(piece)}"] = arr
            piece_sz += arr.nbytes
            if piece_sz >= self.piece_bytes:
                np.savez(os.path.join(tmp, f"piece_{piece_idx:05d}.npz"),
                         **piece)
                manifest["pieces"].append(piece_idx)
                piece, piece_sz = {}, 0
                piece_idx += 1
        if piece:
            np.savez(os.path.join(tmp, f"piece_{piece_idx:05d}.npz"), **piece)
            manifest["pieces"].append(piece_idx)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        # emit the swarm metainfo: a PieceManifest (content-hashed, like a
        # .torrent) over the step's canonical packed image, so replicas
        # can join the distribution swarm straight off the step directory.
        # Successive committed steps form a revision chain (version +
        # prev_manifest_hash): a replica holding v(k) seeds its v(k+1)
        # inventory from the pieces the delta left unchanged.
        prev_pm = None
        prior = [s for s in self.steps() if s < step]
        if prior:
            try:
                prev_pm = self.swarm_manifest(prior[-1])
            except Exception:
                prev_pm = None
        pm = PieceManifest.from_bytes(
            self.swarm_app_id(step), pack_step_image(tmp),
            self.swarm_piece_bytes,
            version=(prev_pm.version + 1 if prev_pm is not None else 1),
            prev=prev_pm)
        with open(os.path.join(tmp, "swarm.json"), "w") as f:
            json.dump({"app_id": pm.app_id, "piece_bytes": pm.piece_bytes,
                       "total_bytes": pm.total_bytes,
                       "piece_hashes": list(pm.piece_hashes),
                       "version": pm.version,
                       "prev_manifest_hash": pm.prev_manifest_hash,
                       "manifest_hash": pm.manifest_hash}, f)
        with open(os.path.join(tmp, "COMMITTED"), "w") as f:
            f.write(str(time.time()))
        if os.path.isdir(d):
            shutil.rmtree(d)
        os.rename(tmp, d)
        self._gc()
        return d

    # ------------------------------------------------------------------ #
    def swarm_app_id(self, step: int) -> str:
        """The Application id a step is advertised under in the swarm."""
        return f"ckpt-{os.path.basename(os.path.normpath(self.root))}" \
               f"-step{step:08d}"

    def pack_image(self, step: Optional[int] = None) -> bytes:
        """The committed step's canonical swarm image bytes."""
        step = step if step is not None else self.latest_step()
        assert step is not None, "no committed checkpoint found"
        return pack_step_image(self.step_dir(step))

    def swarm_manifest(self, step: Optional[int] = None) -> PieceManifest:
        """The PieceManifest `save` emitted for a committed step
        (rebuilt from the files for pre-swarm.json step dirs)."""
        step = step if step is not None else self.latest_step()
        assert step is not None, "no committed checkpoint found"
        path = os.path.join(self.step_dir(step), "swarm.json")
        if not os.path.exists(path):
            return PieceManifest.from_bytes(self.swarm_app_id(step),
                                            self.pack_image(step),
                                            self.swarm_piece_bytes)
        with open(path) as f:
            doc = json.load(f)
        pm = PieceManifest(doc["app_id"], int(doc["piece_bytes"]),
                           int(doc["total_bytes"]),
                           tuple(doc["piece_hashes"]), content_hashed=True,
                           version=int(doc.get("version", 1)),
                           prev_manifest_hash=doc.get("prev_manifest_hash"))
        assert pm.manifest_hash == doc["manifest_hash"], \
            "swarm.json does not match its own metainfo"
        return pm

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep_last]:
            shutil.rmtree(os.path.join(self.root, f"step_{s:08d}"),
                          ignore_errors=True)

    def steps(self) -> List[int]:
        out = []
        for fn in sorted(os.listdir(self.root)):
            d = os.path.join(self.root, fn)
            if fn.startswith("step_") and \
                    os.path.exists(os.path.join(d, "COMMITTED")):
                out.append(int(fn[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    # ------------------------------------------------------------------ #
    def restore(self, template, step: Optional[int] = None, *,
                device="cuda") -> Tuple[Any, dict]:
        """Restore into the structure of `template`: nested dicts of
        tensors (each leaf comes back on its template's device, in its
        dtype) or of `ParamSpec`s (on ``device``: "cuda" by default,
        "cpu" on request)."""
        step = step if step is not None else self.latest_step()
        assert step is not None, "no committed checkpoint found"
        d = os.path.join(self.root, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        entries = {leaf["key"]: leaf for leaf in manifest["leaves"]}
        pieces: Dict[int, Any] = {}

        def load(key, want):
            if key not in entries:
                raise KeyError(f"checkpoint step {step} holds no leaf {key}")
            ent = entries[key]
            pid = ent["piece"]
            if pid not in pieces:
                pieces[pid] = np.load(
                    os.path.join(d, f"piece_{pid:05d}.npz"))
            return _restore_leaf(key, pieces[pid][ent["name"]],
                                 ent["dtype"], want, device)

        try:
            tree = _rebuild(template, load)
        finally:
            for z in pieces.values():
                z.close()
        return tree, manifest["extra"]

    def restore_distributed(self, template, mesh, step: Optional[int] = None,
                            pod_axis: str = "pod", *, device="cuda"
                            ) -> Tuple[Any, dict]:
        """Torrent restore: the seeder pod reads, the pieces ride the ring.

        ``mesh`` is a `DeviceMesh` whose ``pod_axis`` names a process
        group, and every rank of that group calls this.  Rank 0 of the
        group (the seeder) restores from the store; the other ranks read
        nothing from it: they receive the seeder's bytes through
        `weight_torrent.torrent_broadcast` (`pod_restore`), and the
        manifest's ``extra`` too.  Leaves land on their template's device
        (``device`` for `ParamSpec` leaves).  A ``mesh`` of None, or one
        without ``pod_axis``, is `restore`.
        """
        return pod_restore(
            lambda: self.restore(template, step, device=device), template,
            mesh, pod_axis, device)


def _allocate(template, device):
    """Uninitialised tensors shaped after ``template``: a tensor leaf's
    device and dtype, or a `ParamSpec`'s dtype on ``device``."""
    def empty(key, want):
        if isinstance(want, torch.Tensor):
            return torch.empty_like(want)
        if isinstance(want, ParamSpec):
            return torch.empty(want.shape, dtype=want.dtype,
                               device=resolve_device(device))
        raise TypeError(f"template leaf {key}: expected a tensor or a "
                        f"ParamSpec, got {type(want).__name__}")
    return _rebuild(template, empty)


def pod_restore(load, template, mesh, pod_axis: str = "pod", device="cuda"):
    """``load()`` -> (tree, extra) on the seeder, rank 0 of ``mesh``'s
    ``pod_axis``, and its result on every rank of the axis: the other
    ranks never call ``load``; they allocate ``template``'s leaves and
    receive the seeder's bytes over the torrent ring (pieces of
    ``RING_PIECE_BYTES``), and ``extra`` by ``broadcast_object_list``.
    Without a mesh, or without the axis, this is ``load()``."""
    import torch.distributed as dist
    from repro_torch.parallel import weight_torrent as wt
    group = wt.axis_group(mesh, pod_axis)
    if group is None:
        return load()
    if dist.get_rank(group) == 0:
        tree, extra = load()
    else:
        tree, extra = _allocate(template, device), None
    box = [extra]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0),
                               group=group)
    tree = wt.torrent_broadcast(tree, mesh, axis=pod_axis, seeder=0,
                                n_pieces=wt.ring_pieces(tree))
    return tree, box[0]


def _snapshot(tree):
    """A host copy of every leaf: a CPU tensor's numpy view aliases its
    storage, which the next optimizer step updates in place."""
    if isinstance(tree, dict):
        return {k: _snapshot(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return np.array(tree, copy=True)


def async_save(store: CheckpointStore, step: int, tree,
               extra: Optional[dict] = None) -> threading.Thread:
    """Snapshot to host (a copy, on the caller's thread), then serialise
    in a background thread."""
    host_tree = _snapshot(tree)
    th = threading.Thread(target=store.save, args=(step, host_tree, extra),
                          daemon=True)
    th.start()
    return th
