"""Keyframe store: a fixed-capacity ring buffer of keyframes (port of
``mapping/keyframe.py``).

A struct-of-arrays dataclass of tensors with the slot axis first. Each slot
keeps the sparse level-0 data the windowed BA (``mapping/ba.py``) works on:
points, inverse depths, intensities, the level-0 image and the pose. Updates
return a new store whose changed fields are fresh tensors (the old store is
left as it was), as the reference's functional updates do; the slot and the
ring cursor stay on the device, so an insert makes no host read.
"""

from __future__ import annotations

import dataclasses

import torch

from odometry_torch.device import resolve_device
from odometry_torch.kernels.points import PointSet


@dataclasses.dataclass(frozen=True)
class KeyframeStore:
    """Ring buffer of K keyframes; tensors lead with the slot axis."""

    xs: torch.Tensor  # (K, cap) point pixel x
    ys: torch.Tensor  # (K, cap)
    inv_depth: torch.Tensor  # (K, cap)
    intensity: torch.Tensor  # (K, cap) keyframe image at the point
    point_valid: torch.Tensor  # (K, cap) bool
    image: torch.Tensor  # (K, H, W) level-0 keyframe image (BA sampling target)
    pose: torch.Tensor  # (K, 4, 4) cam-to-world
    frame_id: torch.Tensor  # (K,) int32 source frame index
    occupied: torch.Tensor  # (K,) bool slot in use
    head: torch.Tensor  # int32: next slot to write (ring cursor)
    count: torch.Tensor  # int32: total keyframes ever inserted
    # (K, H // THUMB_FACTOR, W // THUMB_FACTOR) mean-pooled, standardized
    # appearance thumbnails (the loop-closure proposal's descriptor).
    thumb: torch.Tensor
    path: torch.Tensor  # (K,) float32 trajectory length (m) at insertion


THUMB_FACTOR = 16


def thumbnail(image: torch.Tensor) -> torch.Tensor:
    """16x16 mean-pool + per-thumb standardization (zero mean, unit norm);
    trailing pixels that do not fill a pool cell are dropped."""
    H, W = image.shape
    th, tw = H // THUMB_FACTOR, W // THUMB_FACTOR
    t = image[: th * THUMB_FACTOR, : tw * THUMB_FACTOR]
    t = t.reshape(th, THUMB_FACTOR, tw, THUMB_FACTOR).mean(dim=(1, 3))
    t = t - torch.mean(t)
    return t / torch.clamp(torch.linalg.norm(t), min=1e-6)


def create_store(capacity_kf: int, capacity_pts: int, height: int = 0, width: int = 0, *,
                 device="cuda") -> KeyframeStore:
    """An empty store on `device`. height/width size the per-slot image
    planes (0x0 when the store's user never samples images)."""
    dev = resolve_device(device)
    K, P = capacity_kf, capacity_pts
    f32 = dict(dtype=torch.float32, device=dev)
    return KeyframeStore(
        xs=torch.zeros((K, P), **f32),
        ys=torch.zeros((K, P), **f32),
        inv_depth=torch.zeros((K, P), **f32),
        intensity=torch.zeros((K, P), **f32),
        point_valid=torch.zeros((K, P), dtype=torch.bool, device=dev),
        image=torch.zeros((K, height, width), **f32),
        pose=torch.eye(4, **f32).expand(K, 4, 4).clone(),
        frame_id=torch.full((K,), -1, dtype=torch.int32, device=dev),
        occupied=torch.zeros((K,), dtype=torch.bool, device=dev),
        head=torch.tensor(0, dtype=torch.int32, device=dev),
        count=torch.tensor(0, dtype=torch.int32, device=dev),
        thumb=torch.zeros((K, height // THUMB_FACTOR, width // THUMB_FACTOR), **f32),
        path=torch.zeros((K,), **f32),
    )


def _set_slot(a: torch.Tensor, slot: torch.Tensor, value) -> torch.Tensor:
    """A copy of `a` with row `slot` (a device scalar) set to `value`."""
    value = torch.as_tensor(value, dtype=a.dtype, device=a.device)
    return a.index_copy(0, slot.reshape(1).long(), value.expand(a.shape[1:]).unsqueeze(0))


def insert_keyframe(store: KeyframeStore, pts: PointSet, intensity: torch.Tensor,
                    pose: torch.Tensor, frame_id, image: torch.Tensor | None = None,
                    path=0.0) -> KeyframeStore:
    """Write a keyframe at the ring head (the oldest slot is evicted when
    full). `pts` capacity must equal the store's point capacity; `image`
    must match the store's (H, W) when given (0x0 stores skip it and keep
    empty thumbnails). `path`: trajectory length (m) at this keyframe."""
    slot = store.head
    K = store.pose.shape[0]
    keep_image = image is None or store.image.numel() == 0
    keep_thumb = image is None or store.thumb.numel() == 0
    return KeyframeStore(
        xs=_set_slot(store.xs, slot, pts.xs),
        ys=_set_slot(store.ys, slot, pts.ys),
        inv_depth=_set_slot(store.inv_depth, slot, pts.inv_depth),
        intensity=_set_slot(store.intensity, slot, intensity),
        point_valid=_set_slot(store.point_valid, slot, pts.valid),
        image=store.image if keep_image else _set_slot(store.image, slot, image),
        pose=_set_slot(store.pose, slot, pose),
        frame_id=_set_slot(store.frame_id, slot, frame_id),
        occupied=_set_slot(store.occupied, slot, True),
        head=(slot + 1) % K,
        count=store.count + 1,
        thumb=store.thumb if keep_thumb else _set_slot(store.thumb, slot, thumbnail(image)),
        path=_set_slot(store.path, slot, path),
    )


def maybe_insert_keyframe(store: KeyframeStore, do_insert, pts: PointSet,
                          intensity: torch.Tensor, pose: torch.Tensor, frame_id,
                          image: torch.Tensor | None = None, path=0.0) -> KeyframeStore:
    """Insert when `do_insert` (a bool or a device bool), as a select between
    the updated and the old store: no host read."""
    inserted = insert_keyframe(store, pts, intensity, pose, frame_id, image, path)
    do = torch.as_tensor(do_insert, dtype=torch.bool, device=store.pose.device)
    return KeyframeStore(**{
        f.name: torch.where(do, getattr(inserted, f.name), getattr(store, f.name))
        for f in dataclasses.fields(KeyframeStore)
    })


def window_slots(store: KeyframeStore, window: int) -> torch.Tensor:
    """Slot indices (int32) of the most recent `window` keyframes, newest
    last. With fewer than `window` inserted, the missing entries repeat the
    earliest slot (callers mask with `occupied`)."""
    K = store.pose.shape[0]
    newest = (store.head - 1) % K
    offs = torch.arange(window - 1, -1, -1, dtype=torch.int32, device=store.head.device)
    slots = (newest - offs) % K
    n = torch.clamp(store.count, max=K)
    earliest = (store.head - n) % K
    return torch.where(offs < n, slots, earliest).to(torch.int32)


def update_poses(store: KeyframeStore, slots: torch.Tensor,
                 new_poses: torch.Tensor) -> KeyframeStore:
    """Write back BA-refined poses for `slots` (a new store)."""
    pose = store.pose.clone()
    pose[slots.long()] = new_poses.to(pose.dtype)
    return dataclasses.replace(store, pose=pose)
