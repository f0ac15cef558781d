"""Mesh renderer (counterpart of ``viz/renderer.py``).

A perspective camera on the reference's viewpoint convention (dist 2.5,
elev 0, azim 15°, point light at (0, 0, 3)), per-vertex Gouraud diffuse
shading, and the z-buffer rasterizer of ``raster.py``. On the card a
batch of meshes is shaded, projected, swept (one launch of kernel K7)
and resolved as batched tensor ops; on the host the same ops run in
sub-batches of ``max_vmap`` with the sweep's plain twin. There is no
other rasterizer.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .raster import meshes_per_launch, rasterize_batch

__all__ = ["look_at_camera", "vertex_normals", "render_mesh",
           "render_batch", "make_image_grid"]


def look_at_camera(dist: float = 2.5, elev_deg: float = 0.0,
                   azim_deg: float = 15.0):
    """(eye [3], R [3,3]) world→camera rotation for a camera orbiting the
    origin (reference viewpoint: look_at_view_transform(2.5, 0, 15))."""
    elev = np.deg2rad(elev_deg)
    azim = np.deg2rad(azim_deg)
    eye = np.array([dist * np.cos(elev) * np.sin(azim),
                    dist * np.sin(elev),
                    dist * np.cos(elev) * np.cos(azim)])
    forward = -eye / np.linalg.norm(eye)            # toward origin
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(forward, up)
    right /= np.linalg.norm(right)
    true_up = np.cross(right, forward)
    rot = np.stack([right, true_up, -forward])       # rows: cam axes
    return eye.astype(np.float32), rot.astype(np.float32)


def vertex_normals(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Area-weighted per-vertex normals ``[..., V, 3]``."""
    v0, v1, v2 = (verts[..., faces[:, i], :] for i in range(3))
    fn = torch.linalg.cross(v1 - v0, v2 - v0, dim=-1)       # [..., F, 3]
    n = torch.zeros_like(verts)
    for i in range(3):
        n.index_add_(-2, faces[:, i], fn)
    return n / (torch.linalg.vector_norm(n, dim=-1, keepdim=True) + 1e-12)


def _shade(verts, faces, colors, light_pos):
    normals = vertex_normals(verts, faces)
    light = light_pos - verts
    light = light / (torch.linalg.vector_norm(light, dim=-1, keepdim=True)
                     + 1e-12)
    diffuse = torch.clamp(torch.sum(normals * light, dim=-1), 0.0, 1.0)
    return colors * (0.25 + 0.75 * diffuse)[..., None]


def _to_camera(verts, eye, rot):
    """``(verts − eye) · rotᵀ`` written out elementwise, so that a mesh
    gets the same bits in any batch."""
    d = verts - eye
    return (d[..., 0:1] * rot[:, 0] + d[..., 1:2] * rot[:, 1]
            + d[..., 2:3] * rot[:, 2])


def _tensor(a, dtype, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def _render(verts, faces, colors, eye, rot, light, image_size, shadeless,
            background):
    if not shadeless:
        colors = _shade(verts, faces, colors, light)
    return rasterize_batch(_to_camera(verts, eye, rot), faces, colors,
                           image_size=image_size, background=background)


def render_batch(batched_verts, faces, vertex_colors=None,
                 image_size: int = 256, dist: float = 2.5,
                 elev: float = 0.0, azim: float = 15.0,
                 shadeless: bool = False, light_pos=(0.0, 0.0, 3.0),
                 max_vmap: int = 4, background: float = 0.0,
                 quantize_transfer: bool = True, device=None) -> np.ndarray:
    """``[B, N, 3] → [B, H, W, 3]`` float images in [0, 1].

    ``vertex_colors`` is ``[N, 3]`` (shared) or ``[B, N, 3]``, default
    grey. ``shadeless=True`` samples the colours directly, as the
    reference's error colormaps do. ``device=None`` renders on the card.

    On the card the whole batch is rendered at once (one K7 launch per
    ``meshes_per_launch`` meshes) and the frames are stacked there; with
    ``quantize_transfer`` they cross to the host as uint8 (round(255·v))
    and come back as ``uint8 / 255``, as the JAX package's accelerator
    path does. ``max_vmap`` is ignored there. On the host the meshes are
    rendered in sub-batches of ``max_vmap`` and returned unquantized."""
    dev = resolve_device(device)
    verts = _tensor(batched_verts, torch.float32, dev)
    faces_t = _tensor(faces, torch.int64, dev)
    if vertex_colors is None:
        colors = torch.full_like(verts, 0.5)
    else:
        colors = _tensor(vertex_colors, torch.float32, dev)
        if colors.dim() == 2:
            colors = colors.expand_as(verts)
    eye, rot = look_at_camera(dist, elev, azim)
    eye_t = torch.as_tensor(eye, device=dev)
    rot_t = torch.as_tensor(rot, device=dev)
    light = torch.as_tensor(np.asarray(light_pos, np.float32), device=dev)
    step = meshes_per_launch(image_size) if dev.type == "cuda" \
        else max(1, max_vmap)

    with torch.no_grad():
        frames = [_render(verts[s:s + step], faces_t, colors[s:s + step],
                          eye_t, rot_t, light, image_size, shadeless,
                          background)
                  for s in range(0, len(verts), step)]
        out = torch.clamp(torch.cat(frames), 0.0, 1.0)
        if dev.type == "cuda" and quantize_transfer:
            packed = torch.round(out * 255.0).to(torch.uint8)
            return packed.cpu().numpy().astype(np.float32) / 255.0
    return out.cpu().numpy()


def render_mesh(verts, faces, vertex_colors=None, image_size: int = 256,
                dist: float = 2.5, elev: float = 0.0, azim: float = 15.0,
                shadeless: bool = False, light_pos=(0.0, 0.0, 3.0),
                max_vmap: int = 4, background: float = 0.0,
                quantize_transfer: bool = False, device=None) -> np.ndarray:
    """One mesh ``[N, 3]`` → ``[H, W, 3]`` float image in [0, 1]; the
    other arguments go to ``render_batch`` (unquantized by default, as
    the JAX package's ``render_mesh`` returns floats)."""
    dev = resolve_device(device)
    colors = None if vertex_colors is None else \
        _tensor(vertex_colors, torch.float32, dev)
    return render_batch(_tensor(verts, torch.float32, dev)[None], faces,
                        colors, image_size=image_size, dist=dist, elev=elev,
                        azim=azim, shadeless=shadeless, light_pos=light_pos,
                        max_vmap=max_vmap, background=background,
                        quantize_transfer=quantize_transfer, device=dev)[0]


def make_image_grid(images: np.ndarray, nrow: int = 4, padding: int = 10,
                    pad_value: float = 1.0) -> np.ndarray:
    """[B, H, W, 3] → single grid image (torchvision make_grid analog)."""
    b, h, w, c = images.shape
    ncol = nrow
    nrows = -(-b // ncol)
    grid = np.full((nrows * (h + padding) + padding,
                    ncol * (w + padding) + padding, c), pad_value,
                   np.float32)
    for i in range(b):
        r, col = divmod(i, ncol)
        y = padding + r * (h + padding)
        x = padding + col * (w + padding)
        grid[y:y + h, x:x + w] = images[i]
    return grid
