import numpy as np
import pytest

from ddpca_admm.mesh.hexmesh import HexMesh
from ddpca_admm.mesh.templates import PATTERN_ARRAYS, PATTERN_AXES, TEMPLATES


def make_unit_mesh(div=2):
    m = HexMesh()
    m.add_box_grid(np.zeros(3), np.ones(3) / div, (div, div, div))
    return m


def test_templates_children_partition_volume():
    for s, t in TEMPLATES.items():
        boxes = t.child_corner_pos  # (nc,8,3)
        vol = 0.0
        for c in range(boxes.shape[0]):
            lo = boxes[c].min(axis=0)
            hi = boxes[c].max(axis=0)
            vol += np.prod(hi - lo)
        assert vol == 8, f"pattern {s}"


def test_templates_new_node_counts():
    # 0: 12 edges + 6 faces + center; 1-3: 8 edges + 2 faces; 4-6: 4 edges
    expect = {0: 19, 1: 10, 2: 10, 3: 10, 4: 4, 5: 4, 6: 4}
    for s, t in TEMPLATES.items():
        assert len(t.new_nodes) == expect[s]


def test_grid_dedup():
    m = make_unit_mesh(2)
    assert m.n_nodes == 27
    assert m.n_elems == 8


def test_uniform_refine_counts():
    m = make_unit_mesh(1)
    m.refine_uniform(2)
    # 1 -> 8 -> 64 leaves; total elems 1+8+64
    assert m.leaf_elems().size == 64
    assert m.n_elems == 73
    assert m.n_nodes == 125  # 5^3 lattice


def test_anisotropic_refine():
    m = make_unit_mesh(1)
    leaves = m.leaf_elems()
    m.elem_patt[leaves] = 6  # zeta only
    m.refine(set(leaves))
    assert m.leaf_elems().size == 2
    assert m.n_nodes == 12


def test_two_to_one_rule():
    # refine one of 2 adjacent cells twice: neighbor must be forced to refine
    m = HexMesh()
    m.add_box_grid(np.zeros(3), np.array([0.5, 1.0, 1.0]), (2, 1, 1))
    m.elem_patt[0] = 0
    kids = m.refine({0}, spli_flag={0: {0, 1, 2, 3, 4, 5, 6, 7}})
    # refine all children of elem 0 again -> neighbor elem 1 must refine too
    for k in kids:
        m.elem_patt[k] = 0
    m.refine(set(kids))
    levels = m.elem_level[m.leaf_elems()]
    # neighbor (was level 0) must now be refined -> no leaf at level 0
    assert levels.min() >= 1
    # and adjacency level difference <= 1 everywhere
    assert levels.max() - levels.min() <= 1


def test_transfer_prolongation_partition_of_unity():
    m = make_unit_mesh(2)
    # refine one corner element fully, twice (creates hanging nodes)
    m.elem_patt[0] = 0
    kids = m.refine({0}, spli_flag={0: set(range(8))})
    for k in kids:
        m.elem_patt[k] = 0
    m.refine(set(kids))
    m.transfer()
    # rows of each prolongation sum to 1 (interpolation of constants)
    for P in m.scal_prol:
        rs = np.asarray(P.sum(axis=1)).ravel()
        assert np.allclose(rs, 1.0), "prolongation must preserve constants"
    # hanging nodes: coordinates equal parent average after PATCH
    for node, parents in m.fino_cono.items():
        avg = m.coords[np.array(parents)].mean(axis=0)
        assert np.allclose(m.coords[node], avg)


def test_transfer_level_structure():
    m = make_unit_mesh(1)
    m.refine_uniform(2)
    m.transfer()
    # uniform refinement: no hanging nodes, 3 real levels
    assert m.level_nodes[0].size == 8
    assert m.level_nodes[1].size == 27 - 8
    assert m.level_nodes[2].size == 125 - 27
    assert m.level_nodes[3].size == 0  # artificial hanging level empty
    # maxiLeve+1 prolongations; the last maps real-finest -> full node set
    # (hanging-node interpolation, identity here)
    assert len(m.scal_prol) == 3
    # interpolation of linear field is exact for uniform refinement
    lin = m.coords @ np.array([1.0, 2.0, 3.0]) + 0.5
    lin_pos = lin[m.pos_node]  # reordered by level position
    fine = m.scal_prol[2] @ (m.scal_prol[1] @ (m.scal_prol[0] @ lin_pos[:8]))
    # only checks nodes interpolated from corners: for uniform grids the
    # 2-level interpolation of the trilinear coordinates is exact
    assert np.allclose(fine, lin_pos)


def test_rigid_transform_keeps_dedup():
    m = make_unit_mesh(2)
    th = 0.3
    R = np.array(
        [[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1.0]]
    )
    m.rigid_transform(R, np.array([1.0, 2.0, 3.0]))
    ids = m.add_nodes(m.coords[:5])
    assert np.array_equal(ids, np.arange(5))
