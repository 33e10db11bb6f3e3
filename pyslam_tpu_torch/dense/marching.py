"""Mesh extraction from the sparse TSDF voxel hash: marching tetrahedra.

Copied from ``pyslam_tpu/dense/marching.py`` (numpy only, host-side output
work).  Each cube of 8 voxel centres splits into 6 tetrahedra whose surface
cases (one-vs-three or two-vs-two sign splits) need no case table, and the
work is vectorised over all candidate tetrahedra at once.
"""

from __future__ import annotations

import numpy as np

# cube corner offsets (z-minor order)
_CORNERS = np.array(
    [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
     [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], np.int64
)
# 6 tetrahedra per cube sharing the main diagonal 0-6
_TETS = np.array(
    [[0, 1, 2, 6], [0, 2, 3, 6], [0, 3, 7, 6],
     [0, 7, 4, 6], [0, 4, 5, 6], [0, 5, 1, 6]], np.int64
)
# the 6 edges of a tetrahedron as local vertex index pairs
_TET_EDGES = np.array(
    [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], np.int64
)


def _encode(coords: np.ndarray) -> np.ndarray:
    """(N,3) int -> int64 key (21 bits per axis, offset to positive)."""
    c = coords.astype(np.int64) + (1 << 20)
    return (c[:, 0] << 42) | (c[:, 1] << 21) | c[:, 2]


def marching_tetrahedra(keys: np.ndarray, tsdf: np.ndarray,
                        colors: np.ndarray | None = None,
                        voxel_size: float = 1.0,
                        min_abs_sdf: float = 1.0):
    """keys: (V,3) int voxel coords with valid TSDF values in [-1,1].

    Returns (vertices (M,3) float, faces (F,3) int, vertex_colors (M,3) or
    None).  Vertices are deduplicated by quantized position.
    """
    if len(keys) == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64), None
    enc = _encode(keys)
    order = np.argsort(enc)
    enc_sorted = enc[order]
    tsdf_sorted = tsdf[order]
    col_sorted = colors[order] if colors is not None else None

    # candidate cubes: every voxel anchors a cube; all 8 corners must exist
    corners = keys[:, None, :] + _CORNERS[None, :, :]       # (V,8,3)
    cenc = _encode(corners.reshape(-1, 3)).reshape(-1, 8)
    pos = np.searchsorted(enc_sorted, cenc)
    pos = np.clip(pos, 0, len(enc_sorted) - 1)
    found = enc_sorted[pos] == cenc
    cube_ok = found.all(axis=1)
    if not cube_ok.any():
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64), None
    cube_idx = pos[cube_ok]                                  # (C,8) row ids
    cube_base = keys[cube_ok]                                # (C,3)
    f = tsdf_sorted[cube_idx]                                # (C,8) sdf values
    col8 = col_sorted[cube_idx] if col_sorted is not None else None

    # corner positions (voxel centers)
    P = (cube_base[:, None, :] + _CORNERS[None] + 0.5) * voxel_size  # (C,8,3)

    verts_out, cols_out = [], []

    for tet in _TETS:
        ft = f[:, tet]                                       # (C,4)
        pt = P[:, tet]                                       # (C,4,3)
        ct = col8[:, tet] if col8 is not None else None
        neg = ft < 0
        nneg = neg.sum(axis=1)
        # skip empty/full tets
        active = (nneg > 0) & (nneg < 4)
        if not active.any():
            continue
        ftA, ptA = ft[active], pt[active]
        ctA = ct[active] if ct is not None else None
        negA = neg[active]
        nnegA = nneg[active]

        # edge crossing interpolation for all 6 edges
        e0, e1 = _TET_EDGES[:, 0], _TET_EDGES[:, 1]
        fa, fb = ftA[:, e0], ftA[:, e1]                      # (A,6)
        cross = (fa < 0) != (fb < 0)
        t = fa / np.where(np.abs(fa - fb) < 1e-12, 1e-12, fa - fb)
        t = np.clip(t, 0.0, 1.0)
        pe = ptA[:, e0] + t[..., None] * (ptA[:, e1] - ptA[:, e0])  # (A,6,3)
        if ctA is not None:
            ce = ctA[:, e0] + t[..., None] * (ctA[:, e1] - ctA[:, e0])

        # case 1/3: exactly one corner on the minority side -> ONE triangle
        # over the three edges incident to that corner
        # edges incident to local vertex v
        inc = np.array([[0, 1, 2], [0, 3, 4], [1, 3, 5], [2, 4, 5]])
        for minority in (1, 3):
            sel = nnegA == minority
            if not sel.any():
                continue
            m = negA[sel] if minority == 1 else ~negA[sel]
            vidx = np.argmax(m, axis=1)                      # the lone corner
            edges3 = inc[vidx]                               # (S,3)
            tri = np.take_along_axis(
                pe[sel], edges3[:, :, None].repeat(3, 2), axis=1
            )                                                # (S,3,3)
            verts_out.append(tri.reshape(-1, 3))
            if ctA is not None:
                tric = np.take_along_axis(
                    ce[sel], edges3[:, :, None].repeat(3, 2), axis=1
                )
                cols_out.append(tric.reshape(-1, 3))

        # case 2/2: two corners each side -> quad over the four crossing
        # edges, split into two triangles (order the edges so the quad is
        # non-self-intersecting: edges sharing a minority corner are
        # adjacent)
        sel = nnegA == 2
        if sel.any():
            crossS = cross[sel]                              # (S,6)
            peS = pe[sel]
            ceS = ce[sel] if ctA is not None else None
            negS = negA[sel]
            S = crossS.shape[0]
            # the 4 crossing edges per tet
            eidx = np.argsort(~crossS, axis=1)[:, :4]        # (S,4) edge ids
            # order: pick minority pair (a,b); edges from a: (a,x),(a,y);
            # edges from b: (b,x),(b,y). Quad = ax, ay, by, bx.
            quads = np.zeros((S, 4), np.int64)
            for s in range(S):
                mins = np.nonzero(negS[s])[0]
                a, b = mins[0], mins[1]
                ea = [e for e in eidx[s] if a in _TET_EDGES[e]]
                eb = [e for e in eidx[s] if b in _TET_EDGES[e]]
                # match opposite corners: ea[0] and eb sharing the same
                # majority vertex must be adjacent in the quad
                other = [v for v in _TET_EDGES[ea[0]] if v != a][0]
                if other in _TET_EDGES[eb[0]]:
                    quads[s] = [ea[0], ea[1], eb[1], eb[0]]
                else:
                    quads[s] = [ea[0], ea[1], eb[0], eb[1]]
            q = np.take_along_axis(
                peS, quads[:, :, None].repeat(3, 2), axis=1
            )                                                # (S,4,3)
            tris = np.concatenate([q[:, [0, 1, 2]], q[:, [0, 2, 3]]], axis=0)
            verts_out.append(tris.reshape(-1, 3))
            if ceS is not None:
                qc = np.take_along_axis(
                    ceS, quads[:, :, None].repeat(3, 2), axis=1
                )
                trisc = np.concatenate(
                    [qc[:, [0, 1, 2]], qc[:, [0, 2, 3]]], axis=0
                )
                cols_out.append(trisc.reshape(-1, 3))

    if not verts_out:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64), None
    V = np.concatenate(verts_out, axis=0)                    # (3F,3)
    C = np.concatenate(cols_out, axis=0) if cols_out else None

    # weld duplicate vertices (quantize to 1e-4 voxel; exact row unique)
    qv = np.round(V / (voxel_size * 1e-4)).astype(np.int64)
    _, uniq_idx, inv = np.unique(
        qv, axis=0, return_index=True, return_inverse=True
    )
    verts = V[uniq_idx]
    cols = C[uniq_idx] if C is not None else None
    faces = inv.reshape(-1, 3)
    # drop degenerate faces
    good = (
        (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    return verts, faces[good], cols


def save_ply(path: str, verts: np.ndarray, faces: np.ndarray,
             colors: np.ndarray | None = None):
    """ASCII PLY writer (vertex positions [+ uchar colors] + faces)."""
    with open(path, "w") as fh:
        fh.write("ply\nformat ascii 1.0\n")
        fh.write(f"element vertex {len(verts)}\n")
        fh.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            fh.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        fh.write(f"element face {len(faces)}\n")
        fh.write("property list uchar int vertex_indices\nend_header\n")
        if colors is not None:
            cc = np.clip(colors, 0, 255).astype(int)
            for v, c in zip(verts, cc):
                fh.write(f"{v[0]:.5f} {v[1]:.5f} {v[2]:.5f} {c[0]} {c[1]} {c[2]}\n")
        else:
            for v in verts:
                fh.write(f"{v[0]:.5f} {v[1]:.5f} {v[2]:.5f}\n")
        for f in faces:
            fh.write(f"3 {f[0]} {f[1]} {f[2]}\n")


def load_ply(path: str):
    """Minimal ASCII PLY reader (round-trip for save_ply)."""
    with open(path) as fh:
        assert fh.readline().strip() == "ply"
        nv = nf = 0
        has_color = False
        for line in fh:
            line = line.strip()
            if line.startswith("element vertex"):
                nv = int(line.split()[-1])
            elif line.startswith("element face"):
                nf = int(line.split()[-1])
            elif line.startswith("property uchar red"):
                has_color = True
            elif line == "end_header":
                break
        verts, cols, faces = [], [], []
        for _ in range(nv):
            vals = fh.readline().split()
            verts.append([float(x) for x in vals[:3]])
            if has_color:
                cols.append([int(x) for x in vals[3:6]])
        for _ in range(nf):
            vals = fh.readline().split()
            faces.append([int(x) for x in vals[1:4]])
    return (
        np.asarray(verts), np.asarray(faces, np.int64),
        np.asarray(cols) if has_color else None,
    )
