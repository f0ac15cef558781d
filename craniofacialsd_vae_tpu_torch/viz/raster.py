"""Tiled edge-function z-buffer rasterizer (counterpart of
``viz/raster_pallas.py``), over a batch of meshes that share their faces.

The three edge functions and the screen-space depth of a triangle are
affine in the pixel coordinates, so rasterization factors into (1) a
per-triangle coefficient build, O(F); (2) a sweep of every pixel against
the triangles that can cover it, keeping the least depth and the lowest
triangle index at it; (3) a winner-indexed barycentric colour resolve,
O(P). Steps (1) and (3) are batched PyTorch on either device. Step (2),
``_zbuffer_sweep``, is kernel K7: for CUDA tensors it launches
``csrc/raster_sweep.cu`` once for the whole batch; for CPU tensors it runs
the plain twin ``_zbuffer_sweep_plain`` mesh by mesh.

The twin is the reference's sweep: every pixel against every 256-triangle
block whose rows meet the pixel's 1024-pixel strip (the strip cull). The
kernel evaluates a pixel against a triangle only where the twin does
and, besides, the pixel centre lies in the triangle's screen box widened
by a margin that rounding cannot cross (``_triangle_boxes``); pairs it
skips cannot be inside, so z and winner agree with the twin bit for bit.
``sweep_pairs`` lists the pairs the kernel evaluates.

Semantics follow the reference rasterizer: a pixel is inside when all
three barycentrics are ≥ 0 (either orientation) and the depth is
> 1e-6; depth is interpolated linearly in screen space; the lowest
triangle index wins ties.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels

__all__ = ["rasterize", "rasterize_batch", "project", "sweep_inputs",
           "sweep_pairs", "meshes_per_launch", "SweepInputs", "PIX_TILE",
           "TRI_BLOCK"]

PIX_TILE = 1024        # pixels per cull strip (the reference's pixel tile)
TRI_BLOCK = 256        # triangles per coefficient block
_NEAR = 1e-6
_FAR = 3.4e38          # "no hit" depth
_NO_HIT = 2147483647   # "no hit" winner
_COEF_COLS = 16        # 4 affine forms × 3 coefficients, padded to 16
# box margins: a pixel centre this far outside a triangle's box cannot be
# found inside it (see _triangle_boxes)
_MIN_MARGIN = 1.0
_ROUND = 2.0 ** -24    # float32 unit roundoff
_WILD = 0.5            # relative rounding above which the box is the plane
# the card's colour resolve holds about this many bytes per pixel and mesh
# ([P, 16] coefficients, indices, three colour gathers), and a launch
# takes as many meshes as fit in _RESOLVE_BYTES
_RESOLVE_BYTES_PER_PIXEL = 256
_RESOLVE_BYTES = 1 << 30


def meshes_per_launch(image_size: int) -> int:
    """Meshes per K7 launch on the card: 64 at 256²."""
    per_mesh = _RESOLVE_BYTES_PER_PIXEL * image_size * image_size
    return max(1, _RESOLVE_BYTES // per_mesh)


class SweepInputs(NamedTuple):
    """What the sweep reads, per mesh of a batch ``[...]``: the twin reads
    ``coef``, ``ymin`` and ``ymax``; the kernel reads all five."""
    coef: torch.Tensor       # [..., Fp, 16] affine coefficients
    box: torch.Tensor        # [..., Fp, 4] widened box (x0, x1, y0, y1)
    block_box: torch.Tensor  # [..., nb, 4] union of each block's boxes
    ymin: torch.Tensor       # [..., nb] the strip cull's block row range
    ymax: torch.Tensor


def _corners(pts: torch.Tensor, faces: torch.Tensor):
    """``[..., V, 3]`` points → ``(x, y, z)``, each ``[..., F, 3]``."""
    tri = pts[..., faces, :]                    # [..., F, 3, 3]
    return tri[..., 0], tri[..., 1], tri[..., 2]


def _area(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    x0, x1, x2 = x.unbind(-1)
    y0, y1, y2 = y.unbind(-1)
    return (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)


def _triangle_coefficients(pts: torch.Tensor, faces: torch.Tensor,
                           n_blocks: int) -> torch.Tensor:
    """``[..., V, 3]`` projected verts (px, py, z) + ``[F, 3]`` faces →
    ``[..., Fp, 16]`` affine coefficients, Fp = n_blocks · 256.

    Cols 0-2/3-5/6-8: (A, B, C) of the three normalized edge functions;
    cols 9-11: (A, B, C) of the depth; cols 12-15 zero. Degenerate and
    padding triangles get a0 = b0 = 0, c0 = −1 so they are never inside."""
    x, y, z = _corners(pts, faces)
    x0, x1, x2 = x.unbind(-1)
    y0, y1, y2 = y.unbind(-1)
    area = _area(x, y)
    ok = area.abs() > 1e-12
    one = torch.ones_like(area)
    inv = torch.where(ok, 1.0 / torch.where(ok, area, one),
                      torch.zeros_like(area))

    # edge function of vertex i is built from the opposite edge (j, k)
    def edge(xj, yj, xk, yk):
        a = -(yk - yj) * inv
        b = (xk - xj) * inv
        c = ((yk - yj) * xj - (xk - xj) * yj) * inv
        return a, b, c

    a0, b0, c0 = edge(x1, y1, x2, y2)
    a1, b1, c1 = edge(x2, y2, x0, y0)
    a2, b2, c2 = edge(x0, y0, x1, y1)
    z0, z1, z2 = z.unbind(-1)
    ad = a0 * z0 + a1 * z1 + a2 * z2
    bd = b0 * z0 + b1 * z1 + b2 * z2
    cd = c0 * z0 + c1 * z1 + c2 * z2

    a0 = torch.where(ok, a0, 0.0)
    b0 = torch.where(ok, b0, 0.0)
    c0 = torch.where(ok, c0, -1.0)

    n_faces = faces.shape[0]
    coef = torch.zeros(pts.shape[:-2] + (n_blocks * TRI_BLOCK, _COEF_COLS),
                       dtype=pts.dtype, device=pts.device)
    coef[..., :n_faces, :12] = torch.stack(
        [a0, b0, c0, a1, b1, c1, a2, b2, c2, ad, bd, cd], dim=-1)
    coef[..., n_faces:, 2] = -1.0           # padding never inside
    return coef


def _block_y_ranges(tri_y: torch.Tensor, n_tblocks: int):
    """``[..., F, 3]`` triangle vertex y pixel coords → per-block
    ``(ymin [..., n_tblocks], ymax [..., n_tblocks])``; padding gets an
    empty range."""
    lead = tri_y.shape[:-2]
    f_pad = n_tblocks * TRI_BLOCK - tri_y.shape[-2]
    tymin = torch.cat([tri_y.amin(dim=-1),
                       tri_y.new_full(lead + (f_pad,), _FAR)], dim=-1)
    tymax = torch.cat([tri_y.amax(dim=-1),
                       tri_y.new_full(lead + (f_pad,), -_FAR)], dim=-1)
    return (tymin.view(lead + (n_tblocks, TRI_BLOCK)).amin(dim=-1),
            tymax.view(lead + (n_tblocks, TRI_BLOCK)).amax(dim=-1))


def _triangle_boxes(pts: torch.Tensor, faces: torch.Tensor,
                    coef: torch.Tensor, image_size: int) -> torch.Tensor:
    """``[..., Fp, 4]`` boxes ``(x0, x1, y0, y1)``: a pixel centre outside
    its triangle's box is never found inside that triangle, so the kernel
    skips it.

    Why the margin suffices. Let λ be the exact barycentrics of the
    triangle, |area| its doubled area, ``span`` the larger side of its
    box and M the largest |coordinate| of its corners and of the image.
    Each edge function as computed (coefficients built and evaluated in
    float32, each operation rounded) is s·λ_i + E_i with
    |E_i| ≤ 28·u·span·M/|area| and |s − 1| ≤ 16·u·span·M/|area|, u = 2⁻²⁴.
    With δ = 64·u·span·M/|area| ≤ 0.5, s ≥ 0.87 and all three ≥ 0 means
    every λ_i ≥ −0.51·δ. A point at distance d beyond the box in x has
    some λ_i ≤ −d / (2·span_x) (the λ sum to 1 and weight corners that
    all lie more than d away on one side), so d ≤ 1.02·span·δ. The
    margin 1 + 4·span·δ covers that with room for the rounding of the box
    itself. Where δ > 0.5 (slivers, corners far off screen, non-finite
    values) the box is the whole plane. Degenerate and padding triangles
    (a0 = b0 = 0, c0 < 0: e0 = c0 < 0 everywhere) get an empty box."""
    x, y, _ = _corners(pts, faces)
    x_lo, x_hi = x.amin(dim=-1), x.amax(dim=-1)
    y_lo, y_hi = y.amin(dim=-1), y.amax(dim=-1)
    span = torch.maximum(x_hi - x_lo, y_hi - y_lo)
    big = torch.maximum(torch.maximum(x.abs().amax(dim=-1),
                                      y.abs().amax(dim=-1)),
                        torch.full_like(span, float(image_size)))
    delta = 64.0 * _ROUND * span * big / _area(x, y).abs()
    margin = _MIN_MARGIN + 4.0 * span * delta
    inf = float("inf")
    wild = ~(delta <= _WILD)                    # NaN included
    box = torch.stack([
        torch.where(wild, -inf, x_lo - margin),
        torch.where(wild, inf, x_hi + margin),
        torch.where(wild, -inf, y_lo - margin),
        torch.where(wild, inf, y_hi + margin)], dim=-1)
    n_faces = faces.shape[0]
    full = torch.empty(coef.shape[:-1] + (4,), dtype=coef.dtype,
                       device=coef.device)
    full[..., :n_faces, :] = box
    empty = ((coef[..., 0] == 0) & (coef[..., 1] == 0)
             & (coef[..., 2] < 0))[..., None]
    never = torch.tensor([inf, -inf, inf, -inf], dtype=coef.dtype,
                         device=coef.device)
    return torch.where(empty, never, full)


def _block_boxes(box: torch.Tensor) -> torch.Tensor:
    """``[..., Fp, 4]`` → ``[..., nb, 4]``: the union of each block's
    boxes (empty boxes add nothing)."""
    b = box.view(box.shape[:-2] + (-1, TRI_BLOCK, 4))
    return torch.stack([b[..., 0].amin(-1), b[..., 1].amax(-1),
                        b[..., 2].amin(-1), b[..., 3].amax(-1)], dim=-1)


def sweep_inputs(pts: torch.Tensor, faces: torch.Tensor,
                 image_size: int) -> SweepInputs:
    """Projected ``pts [..., V, 3]`` and ``faces [F, 3]`` → the sweep's
    inputs, batched over the leading dims."""
    faces = faces.long()
    n_blocks = max(1, -(-faces.shape[0] // TRI_BLOCK))
    coef = _triangle_coefficients(pts, faces, n_blocks)
    box = _triangle_boxes(pts, faces, coef, image_size)
    ymin, ymax = _block_y_ranges(pts[..., faces, 1], n_blocks)
    return SweepInputs(coef, box, _block_boxes(box), ymin, ymax)


def _cull_tile(n_pix: int) -> int:
    return min(PIX_TILE, n_pix)


def _strip_rows(strip: torch.Tensor, cull: int, image_size: int):
    """First row and one past the last row of each cull strip, as the
    twin and the kernel compare them (float32)."""
    lo = ((strip * cull) // image_size).to(torch.float32)
    hi = (((strip + 1) * cull - 1) // image_size + 1).to(torch.float32)
    return lo, hi


def _zbuffer_sweep_plain(coef: torch.Tensor, b_ymin: torch.Tensor,
                         b_ymax: torch.Tensor, image_size: int):
    """Plain twin of K7 for one mesh: one triangle block at a time over
    all pixels, the least depth in the block and the lowest index at it,
    kept only where strictly nearer than the blocks before."""
    dev = coef.device
    n_pix = image_size * image_size
    tile = _cull_tile(n_pix)
    n_tiles = -(-n_pix // tile)
    gid = torch.arange(n_pix, device=dev)
    px = (gid % image_size).to(torch.float32) + 0.5
    py = (gid // image_size).to(torch.float32) + 0.5
    pix_tile = gid // tile
    row_lo, row_hi = _strip_rows(torch.arange(n_tiles, device=dev), tile,
                                 image_size)

    z = torch.full((n_pix,), _FAR, dtype=torch.float32, device=dev)
    win = torch.full((n_pix,), _NO_HIT, dtype=torch.int32, device=dev)
    tri = torch.arange(TRI_BLOCK, dtype=torch.int32, device=dev)[:, None]
    for j in range(b_ymin.shape[0]):
        hit = ((b_ymin[j] <= row_hi) & (b_ymax[j] >= row_lo))[pix_tile]
        c = coef[j * TRI_BLOCK:(j + 1) * TRI_BLOCK]

        def affine(k):
            return c[:, k:k + 1] * px + c[:, k + 1:k + 2] * py \
                + c[:, k + 2:k + 3]                        # [TB, P]

        e0, e1, e2, zv = affine(0), affine(3), affine(6), affine(9)
        inside = (e0 >= 0) & (e1 >= 0) & (e2 >= 0) & (zv > _NEAR) & hit
        depth = torch.where(inside, zv, _FAR)
        zmin = depth.amin(dim=0)
        ids = torch.where(depth == zmin, j * TRI_BLOCK + tri, _NO_HIT)
        better = zmin < z
        z = torch.where(better, zmin, z)
        win = torch.where(better, ids.amin(dim=0), win)
    return z, win


def _zbuffer_sweep(inp: SweepInputs, image_size: int):
    """Batched sweep inputs ``[B, ...]`` → ``(z [B, P], winner [B, P])``:
    one K7 launch on the card, the plain twin mesh by mesh on the host."""
    if not inp.coef.is_cuda:
        out = [_zbuffer_sweep_plain(c, lo, hi, image_size)
               for c, lo, hi in zip(inp.coef, inp.ymin, inp.ymax)]
        return (torch.stack([z for z, _ in out]),
                torch.stack([w for _, w in out]))
    return kernels.raster_sweep(inp.coef, inp.box, inp.block_box,
                                inp.ymin.contiguous(), inp.ymax.contiguous(),
                                image_size, _cull_tile(image_size ** 2))


def sweep_pairs(inp: SweepInputs, image_size: int):
    """The (pixel, triangle) pairs K7 evaluates for one mesh (inputs
    without a batch dim), as two index tensors: pixel centre in the
    triangle's box and the strip cull keeping the pair's (strip, block).
    The kernel's tile and block tests only skip work that holds none of
    these pairs."""
    box, w, dev = inp.box, image_size, inp.box.device
    tri = torch.nonzero((box[:, 0] <= box[:, 1])
                        & (box[:, 2] <= box[:, 3])).squeeze(1)
    b = box[tri]

    def span(lo, hi):     # candidate pixel columns/rows, one wider a side
        first = torch.clamp(torch.floor(lo - 0.5), -1, w).long() - 1
        last = torch.clamp(torch.ceil(hi - 0.5), -1, w).long() + 1
        return first.clamp(0, w - 1), last.clamp(-1, w - 1)

    c0, c1 = span(b[:, 0], b[:, 1])
    r0, r1 = span(b[:, 2], b[:, 3])
    nx = (c1 - c0 + 1).clamp(min=1)
    ny = (r1 - r0 + 1).clamp(min=1)
    counts = nx * ny
    t = torch.repeat_interleave(torch.arange(len(tri), device=dev), counts)
    start = torch.cumsum(counts, 0) - counts
    k = torch.arange(int(counts.sum()), device=dev) - start[t]
    col = c0[t] + k % nx[t]
    row = r0[t] + k // nx[t]
    px = col.to(torch.float32) + 0.5
    py = row.to(torch.float32) + 0.5
    bt = b[t]
    inside_box = ((px >= bt[:, 0]) & (px <= bt[:, 1]) & (py >= bt[:, 2])
                  & (py <= bt[:, 3]))
    pix = row * w + col
    cull = _cull_tile(w * w)
    lo, hi = _strip_rows(pix // cull, cull, w)
    blk = tri[t] // TRI_BLOCK
    strip_keeps = (inp.ymin[blk] <= hi) & (inp.ymax[blk] >= lo)
    keep = inside_box & strip_keeps
    return pix[keep], tri[t][keep]


def project(verts_cam: torch.Tensor, image_size: int,
            fov_deg: float = 60.0) -> torch.Tensor:
    """Camera-frame ``[..., V, 3]`` (−z forward) → screen
    ``(px, py, depth)``."""
    fov = torch.deg2rad(torch.tensor(fov_deg, dtype=torch.float32))
    f = (1.0 / torch.tan(fov / 2)).to(verts_cam.device)
    z = -verts_cam[..., 2]
    zc = torch.clamp(z, min=_NEAR)
    x_ndc = f * verts_cam[..., 0] / zc
    y_ndc = f * verts_cam[..., 1] / zc
    px = (x_ndc * 0.5 + 0.5) * image_size
    py = (0.5 - y_ndc * 0.5) * image_size
    return torch.stack([px, py, z], dim=-1)


def rasterize_batch(verts_cam: torch.Tensor, faces: torch.Tensor,
                    colors: torch.Tensor, image_size: int = 256,
                    fov_deg: float = 60.0,
                    background: float = 0.0) -> torch.Tensor:
    """``verts_cam [B, V, 3]`` (camera frame, −z forward), shared
    ``faces [F, 3]``, ``colors [B, V, 3]`` → ``[B, H, W, 3]`` images on
    the verts' device. Each image equals ``rasterize`` of its mesh bit
    for bit."""
    faces = faces.long()
    n_faces = faces.shape[0]
    inp = sweep_inputs(project(verts_cam, image_size, fov_deg), faces,
                       image_size)
    zbuf, winner = _zbuffer_sweep(inp, image_size)
    miss = zbuf >= _FAR

    # colour resolve: the winner's coefficients re-evaluated at the pixel
    idx = winner.clamp(0, n_faces - 1).long()               # [B, P]
    cw = torch.gather(inp.coef, 1,
                      idx[..., None].expand(-1, -1, _COEF_COLS))
    pid = torch.arange(image_size * image_size, device=verts_cam.device)
    ppx = (pid % image_size).to(torch.float32) + 0.5
    ppy = (pid // image_size).to(torch.float32) + 0.5

    def baries(k):
        return ppx * cw[..., k] + ppy * cw[..., k + 1] + cw[..., k + 2]

    b0, b1, b2 = baries(0), baries(3), baries(6)
    tri = faces[idx]                                        # [B, P, 3]

    def corner(i):
        return torch.gather(colors, 1, tri[..., i, None].expand(-1, -1, 3))

    rgb = (b0[..., None] * corner(0) + b1[..., None] * corner(1)
           + b2[..., None] * corner(2))
    rgb = torch.where(miss[..., None], background, rgb)
    return rgb.view(-1, image_size, image_size, 3)


def rasterize(verts_cam: torch.Tensor, faces: torch.Tensor,
              colors: torch.Tensor, image_size: int = 256,
              fov_deg: float = 60.0,
              background: float = 0.0) -> torch.Tensor:
    """``verts_cam [V, 3]`` (camera frame, −z forward), ``faces [F, 3]``,
    ``colors [V, 3]`` → ``[H, W, 3]`` image on the verts' device."""
    return rasterize_batch(verts_cam[None], faces, colors[None],
                           image_size, fov_deg, background)[0]
