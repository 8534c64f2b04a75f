"""Checkpoint cold-start over the volunteer swarm (the jax<->swarm loop).

A committed `CheckpointStore` step is a regular piece-wise Application:
`checkpoint_application` wraps the step's canonical packed image and the
`swarm.json` PieceManifest into an `Application` the origin agent hosts
(`host_app`), and every serving replica joins as a leecher-then-seeder
through the ordinary `Agent`/`PieceExchange` machinery (hub mode scales
the flash crowd; `AgentConfig.replicate_completed=True` lets replicas
join an app that carries no work parts).

The restore side closes the loop: `restore_from_agent` takes a replica
whose piece set completed, re-hashes the assembled image against the
manifest (content verification — the framing header is trusted only
after this), unpacks the step directory and restores the parameter tree
through `CheckpointStore.restore`, byte-identical to an origin restore.
`ServingEngine.from_swarm` builds an engine straight from that.

Counterpart of `repro.checkpoint.swarm_restore`; the restored leaves come
back as tensors on their template's device (`CheckpointStore.restore`).
"""
from __future__ import annotations

import os
import tempfile
from dataclasses import replace
from typing import Any, Optional, Tuple

from repro_torch.checkpoint.store import CheckpointStore, unpack_step_image
from repro_torch.core.workunit import Application, PieceManifest


def checkpoint_application(store: CheckpointStore,
                           step: Optional[int] = None, *,
                           host_id: str = "origin",
                           app_id: Optional[str] = None) -> Application:
    """The committed step as a swarm Application: real image bytes, the
    store's emitted manifest, and no work parts (pure replication)."""
    step = step if step is not None else store.latest_step()
    assert step is not None, "no committed checkpoint found"
    manifest = store.swarm_manifest(step)
    if app_id is not None and app_id != manifest.app_id:
        # advertise under a caller-chosen id: rebuild the metainfo so the
        # manifest hash still binds (app_id, piece size, content); the
        # revision chain (version, prev hash) rides along unchanged
        image = store.pack_image(step)
        manifest = replace(
            PieceManifest.from_bytes(app_id, image, manifest.piece_bytes),
            version=manifest.version,
            prev_manifest_hash=manifest.prev_manifest_hash)
    else:
        image = store.pack_image(step)
    return Application(manifest.app_id, host_id, app_bytes=len(image),
                      parts=[], swarm=True,
                      piece_bytes=manifest.piece_bytes,
                      manifest=manifest, image=image)


def verify_image(image, manifest: PieceManifest) -> bool:
    """Content re-hash of an assembled image against its metainfo."""
    if image is None or len(image) != manifest.total_bytes:
        return False
    rehash = replace(
        PieceManifest.from_bytes(manifest.app_id, image,
                                 manifest.piece_bytes),
        version=manifest.version,
        prev_manifest_hash=manifest.prev_manifest_hash)
    return rehash.manifest_hash == manifest.manifest_hash


def restore_image(image, manifest: PieceManifest, template,
                  workdir: Optional[str] = None, *, device="cuda"
                  ) -> Tuple[Any, dict]:
    """Verify + unpack an assembled step image and restore `template`."""
    if not verify_image(image, manifest):
        raise ValueError(
            f"image failed content verification against manifest "
            f"{manifest.manifest_hash[:12]} ({manifest.app_id})")
    workdir = workdir or tempfile.mkdtemp(prefix="swarm_restore_")
    # the unpacked directory is a regular committed step: restore through
    # the store so dtype coercion/tree reassembly match an origin restore
    step_dir = os.path.join(workdir, "step_00000000")
    unpack_step_image(image, step_dir)
    return CheckpointStore(workdir).restore(template, step=0, device=device)


def restore_from_agent(agent, app_id: str, template,
                       workdir: Optional[str] = None, *, device="cuda"
                       ) -> Tuple[Any, dict]:
    """Cold-start restore from a replica agent the moment its piece set
    for `app_id` completes (every piece verified by the inventory)."""
    if app_id not in agent.images:
        raise RuntimeError(
            f"{agent.node_id} has not completed the piece set for "
            f"{app_id}; ready gate is agent.images")
    manifest = agent.px.manifests.get(app_id)
    assert manifest is not None, f"{agent.node_id} holds no manifest"
    image = agent.px.assembled_image(app_id)
    return restore_image(image, manifest, template, workdir=workdir,
                         device=device)
