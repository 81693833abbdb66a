"""Sub-face matching for non-conforming interfaces in meshes read from
files.

NumPy copy of circulantpreconditioner_tpu/mesh/conforming.py. Some
tetrahedral files tetrahedralise each warped cell independently, so the two
sides of an interface may split the shared polygon into different
triangles. Matching faces by vertex sets (mesh/unstructured.py) then leaves
both sides unmatched, and they would be taken for boundary. This pass
completes the matching geometrically:

1. candidate faces = boundary faces whose centre is not on a bounding-box
   plane (the same assumption as mesh/topology.py),
2. every candidate pair with opposing normals, overlapping extents and a
   shared vertex is projected onto its mean plane and clipped
   (Sutherland–Hodgman, convex clip region),
3. each overlap piece of area > rel_tol·min(areas) becomes a new interior
   face (area, centroid, the pair's mean normal) between the two cells,
   assigned greedily, nearest pair first, with per-face coverage caps,
4. candidates covered to ≥ 99 % are dropped; partly covered ones keep a
   boundary face with the uncovered area.

The repair always warns. `count_nonconforming_pairs` runs the first phase
alone, which changes nothing (read_mesh warns with it where it does not
repair).
"""

from __future__ import annotations

import numpy as np

from circulantpreconditioner_tpu_torch.mesh.core import INTERIOR, Mesh


def _plane_basis(n: np.ndarray):
    """Two orthonormal vectors spanning the plane with normal n."""
    a = np.array([1.0, 0.0, 0.0]) if abs(n[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
    u = np.cross(n, a)
    u /= np.linalg.norm(u)
    return u, np.cross(n, u)


def _clip(subject: np.ndarray, clip: np.ndarray) -> np.ndarray:
    """Sutherland–Hodgman: clip `subject` polygon by CONVEX `clip` polygon
    (both (k, 2), counter-clockwise). Returns the (possibly empty) overlap."""
    out = subject
    k = len(clip)
    for i in range(k):
        if len(out) == 0:
            return out
        a, b = clip[i], clip[(i + 1) % k]
        edge = b - a
        # inside = left of edge (ccw clip polygon)
        d = (out - a) @ np.array([-edge[1], edge[0]])
        nxt = []
        m = len(out)
        for j in range(m):
            pj, pk = out[j], out[(j + 1) % m]
            dj, dk = d[j], d[(j + 1) % m]
            if dj >= 0:
                nxt.append(pj)
            if (dj >= 0) != (dk >= 0):
                t = dj / (dj - dk)
                nxt.append(pj + t * (pk - pj))
        out = np.asarray(nxt) if nxt else np.empty((0, 2))
    return out


def _poly_area_centroid(p: np.ndarray):
    """Signed area and centroid of a 2D polygon (shoelace)."""
    if len(p) < 3:
        return 0.0, np.zeros(2)
    x, y = p[:, 0], p[:, 1]
    xn, yn = np.roll(x, -1), np.roll(y, -1)
    cross = x * yn - xn * y
    A = 0.5 * cross.sum()
    if abs(A) < 1e-300:
        return 0.0, p.mean(axis=0)
    cx = ((x + xn) * cross).sum() / (6 * A)
    cy = ((y + yn) * cross).sum() / (6 * A)
    return abs(A), np.array([cx, cy])


def _ccw(p: np.ndarray) -> np.ndarray:
    x, y = p[:, 0], p[:, 1]
    if 0.5 * (x * np.roll(y, -1) - np.roll(x, -1) * y).sum() < 0:
        return p[::-1]
    return p


def _proposals(mesh: Mesh, rel_tol: float, plane_tol: float):
    """Phase 1 of the repair, which changes nothing: the candidate faces
    (boundary faces off the bounding-box planes, in the default group) and
    every overlapping opposing pair of them with its clip piece, as
    (cand, areas, [(gap, i, j, area, center3, normal3)]); None where the
    mesh has no candidate."""
    if mesh.dim != 3:
        return None
    fv = getattr(mesh, "face_vertices", None)
    bnd = mesh.boundary_faces()
    if bnd.size == 0:
        return None
    bb = mesh.bbox()
    scale = float((bb[:, 1] - bb[:, 0]).max())
    c = mesh.face_center[bnd]
    on_plane = np.zeros(len(bnd), dtype=bool)
    for ax in range(3):
        for v in bb[ax]:
            on_plane |= np.abs(c[:, ax] - v) < 1e-6 * scale
    cand = bnd[~on_plane]
    if cand.size == 0:
        return None
    # only untagged candidates: faces the file explicitly grouped are real BCs
    cand = cand[mesh.face_group[cand] == mesh.groups.get("Wall", 1)]
    if cand.size == 0 or fv is None:
        return None

    from scipy.spatial import cKDTree

    cc = mesh.face_center[cand]
    nn = mesh.face_normal[cand]
    aa = mesh.face_area[cand]
    diam = np.sqrt(aa)
    tree = cKDTree(cc)
    polys = []
    vsets = []
    pts = mesh.points  # type: ignore[attr-defined]
    for f in cand:
        row = fv[f]
        row = row[row >= 0] if isinstance(row, np.ndarray) else np.asarray(row)
        polys.append(pts[row])
        vsets.append(frozenset(int(v) for v in row))

    proposals = []  # (gap, i, j, area, center3, normal3)
    pairs = tree.query_pairs(r=float(2.0 * diam.max()), output_type="ndarray")
    for i, j in pairs:
        if nn[i] @ nn[j] > -0.5:
            continue
        if np.linalg.norm(cc[i] - cc[j]) > 1.5 * max(diam[i], diam[j]):
            continue
        Li = mesh.face_cells[cand[i], 0]
        Lj = mesh.face_cells[cand[j], 0]
        if Li == Lj:
            continue
        # genuine split-interface pairs share welded vertices (two triangles
        # subdividing one polygon always share part of its rim); opposing
        # faces of a THIN cell, which also pass the coplanarity test, do
        # not, and matching them would short-circuit the cell between
        if not (vsets[i] & vsets[j]):
            continue
        n = nn[i] - nn[j]
        n /= np.linalg.norm(n)
        # both polygons must lie near the common mean plane
        o = 0.5 * (cc[i] + cc[j])
        di = (polys[i] - o) @ n
        dj = (polys[j] - o) @ n
        lim = plane_tol * max(diam[i], diam[j])
        if max(np.abs(di).max(), np.abs(dj).max()) > lim:
            continue
        u, v = _plane_basis(n)
        pi = np.stack([(polys[i] - o) @ u, (polys[i] - o) @ v], axis=1)
        pj = np.stack([(polys[j] - o) @ u, (polys[j] - o) @ v], axis=1)
        inter = _clip(_ccw(pj), _ccw(pi))
        A, ctr2 = _poly_area_centroid(inter)
        if A <= rel_tol * min(aa[i], aa[j]):
            continue
        ctr3 = o + ctr2[0] * u + ctr2[1] * v
        gap = abs((cc[i] - cc[j]) @ n) + 0.5 * (np.abs(di).max() + np.abs(dj).max())
        proposals.append((float(gap), int(i), int(j), float(A), ctr3, n))
    return cand, aa, proposals


def count_nonconforming_pairs(mesh: Mesh, rel_tol: float = 1e-3,
                              plane_tol: float = 0.2) -> int:
    """The number of opposing boundary-face pairs that
    match_nonconforming_faces would couple, found without changing the
    mesh: its first phase alone."""
    found = _proposals(mesh, rel_tol, plane_tol)
    return 0 if found is None else len(found[2])


def match_nonconforming_faces(mesh: Mesh, rel_tol: float = 1e-3,
                              plane_tol: float = 0.2) -> int:
    """Find unmatched opposing boundary-face pairs and replace their overlap
    with interior sub-faces (see the module docstring). Mutates the mesh;
    returns the number of interface pieces created, 0 for a conforming
    mesh."""
    found = _proposals(mesh, rel_tol, plane_tol)
    if found is None:
        return 0
    cand, aa, proposals = found
    fv = mesh.face_vertices  # type: ignore[attr-defined]

    # Phase 2: greedy assignment, best (smallest-gap) matches first, with
    # per-face coverage caps. Sliver stacks produce several mutually
    # overlapping opposing faces; without the caps one face would be clipped
    # against ALL of them and its coverage double-counted (observed: 1.6×
    # over-coverage ⇒ closure violations of O(10) on 90 cells of
    # 3DKershawTetra1). The nearest opposing face is the geometrically
    # correct partner, so it claims the area first; farther proposals only
    # get whatever coverage remains.
    pieces = []  # (i, j, area, center3, normal3)
    covered = np.zeros(len(cand))
    for gap, i, j, A, ctr3, n in sorted(proposals, key=lambda t: t[0]):
        rem = min(aa[i] - covered[i], aa[j] - covered[j])
        A = min(A, rem)
        if A <= rel_tol * min(aa[i], aa[j]):
            continue
        pieces.append((i, j, A, ctr3, n))
        covered[i] += A
        covered[j] += A

    if not pieces:
        return 0

    frac = covered / aa
    drop = frac >= 0.99
    shrink = (~drop) & (frac > 0)

    # The repair is never silent: report how
    # much boundary was rewritten and how much area the >=99%-covered cut
    # discards. The discarded sliver is an O(rel_tol) closure approximation;
    # warn loudly if it ever grows past 0.1% of the candidate boundary area.
    import warnings

    dropped_area = float(((1.0 - frac[drop]).clip(0.0) * aa[drop]).sum())
    mesh.nonconforming_pieces = len(pieces)  # type: ignore[attr-defined]
    mesh.nonconforming_dropped_area = dropped_area  # type: ignore[attr-defined]
    total = float(aa.sum())
    msg = (f"{mesh.name}: non-conforming interface repair created "
           f"{len(pieces)} interior sub-faces from {int(drop.sum())} fully- "
           f"and {int(shrink.sum())} partially-covered boundary faces "
           f"(discarded sliver area {dropped_area:.3e} of {total:.3e} "
           f"candidate)")
    if dropped_area > 1e-3 * total:
        warnings.warn(msg + " — EXCEEDS the 0.1% closure tolerance")
    else:
        warnings.warn(msg)

    keep_mask = np.ones(mesh.face_cells.shape[0], dtype=bool)
    keep_mask[cand[drop]] = False
    mesh.face_area = mesh.face_area.copy()
    mesh.face_area[cand[shrink]] *= np.clip(1.0 - frac[shrink], 0.0, 1.0)

    new_fc = np.array([[mesh.face_cells[cand[i], 0], mesh.face_cells[cand[j], 0]]
                       for i, j, *_ in pieces], dtype=mesh.face_cells.dtype)
    new_area = np.array([p[2] for p in pieces])
    new_ctr = np.stack([p[3] for p in pieces])
    new_nrm = np.stack([p[4] for p in pieces])

    mesh.face_cells = np.concatenate([mesh.face_cells[keep_mask], new_fc])
    mesh.face_area = np.concatenate([mesh.face_area[keep_mask], new_area])
    mesh.face_center = np.concatenate([mesh.face_center[keep_mask], new_ctr])
    mesh.face_normal = np.concatenate([mesh.face_normal[keep_mask], new_nrm])
    mesh.face_group = np.concatenate(
        [mesh.face_group[keep_mask],
         np.full(len(pieces), INTERIOR, dtype=mesh.face_group.dtype)])
    if mesh.periodic_twin is not None:
        mesh.periodic_twin = np.concatenate(
            [mesh.periodic_twin[keep_mask],
             np.full(len(pieces), -1, dtype=mesh.periodic_twin.dtype)])
    if isinstance(fv, np.ndarray):
        pad = np.full((len(pieces), fv.shape[1]), -1, dtype=fv.dtype)
        mesh.face_vertices = np.concatenate([fv[keep_mask], pad])  # type: ignore[attr-defined]
    else:
        kept = [f for f, k in zip(fv, keep_mask) if k]
        mesh.face_vertices = kept + [() for _ in pieces]  # type: ignore[attr-defined]
    return len(pieces)
