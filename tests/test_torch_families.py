"""The port's tag families against the JAX package's: generated families bit
for bit, the registry, the listing and the renderer."""

import numpy as np
import pytest

from aprilslam_tpu import families as JF
from aprilslam_tpu.families.generate import generate_family as j_generate
from aprilslam_tpu_torch import families as TF
from aprilslam_tpu_torch.families.generate import generate_family as t_generate


@pytest.mark.parametrize("n_codes,seed", [(24, 3), (64, 0)])
def test_generate_family_bit_for_bit(n_codes, seed):
    ours = t_generate(n_codes, seed=seed, register=False)
    ref = j_generate(n_codes, seed=seed, register=False)
    assert ours.name == ref.name
    assert ours.grids.dtype == ref.grids.dtype == np.uint8
    np.testing.assert_array_equal(ours.grids, ref.grids)
    for field in ("total_width", "width_at_border", "reversed_border", "min_hamming"):
        assert getattr(ours, field) == getattr(ref, field)
    np.testing.assert_array_equal(ours.codebook()[0], ref.codebook()[0])


def test_generated_family_decodes_and_keeps_ring_polarity():
    """The JAX test's checks (tests/test_families.py, TestGenerate) on the port."""
    fam = t_generate(24, min_hamming=9, total_width=9, seed=3, register=False)
    assert fam.n_codes == 24
    tmpl, meta = fam.codebook()
    mask = fam.sample_mask()
    for tid in [0, 7, 23]:
        sampled = fam.grids[tid][mask].astype(np.float32) * 2 - 1
        best = int(np.argmax(sampled @ tmpl.T))
        assert meta[best, 0] == tid and meta[best, 1] == 0
    black, white = fam.border_rings()
    assert np.all(fam.grids[:, black] == 0)
    assert np.all(fam.grids[:, white] == 1)


def test_generate_refuses_a_margin_too_large():
    with pytest.raises(ValueError, match="too large"):
        t_generate(4, min_hamming=30, register=False)


def test_register_get_and_list_match_jax():
    ours = t_generate(24, name="portTestFamily24", seed=3)
    ref = j_generate(24, name="portTestFamily24", seed=3)
    assert TF.get_family("portTestFamily24") is ours
    assert JF.get_family("portTestFamily24") is ref
    assert "portTestFamily24" in TF.list_families()
    # Other test files may register families in either package's registry.
    builtins = set(TF.list_families()) - set(TF._REGISTRY)
    assert builtins == set(JF.list_families()) - set(JF._REGISTRY) == {"tag36h11", "tagStandard41h12"}
    assert TF.list_families() == sorted(builtins | set(TF._REGISTRY))
    # A registered name shadows a built-in one; the built-ins stay cached.
    assert TF.get_family("tag36h11") is TF.get_family("tag36h11")
    shadow = TF.TagFamily("tag36h11", ours.grids, 9, 5, True, 9)
    try:
        assert TF.register_family(shadow) is shadow
        assert TF.get_family("tag36h11") is shadow
    finally:
        del TF._REGISTRY["tag36h11"]
    assert TF.get_family("tag36h11").n_codes == JF.get_family("tag36h11").n_codes


def test_unknown_family_names_register_family():
    with pytest.raises(ValueError, match="register_family"):
        TF.get_family("noSuchFamily")


@pytest.mark.parametrize("name,tag_id,px", [("tag36h11", 0, 4), ("tagStandard41h12", 3, 16)])
def test_render_matches_jax(name, tag_id, px):
    img = TF.get_family(name).render(tag_id, px_per_cell=px)
    np.testing.assert_array_equal(img, JF.get_family(name).render(tag_id, px_per_cell=px))
    C = TF.get_family(name).total_width
    assert img.shape == (C * px, C * px) and img.dtype == np.uint8
    assert set(np.unique(img)) <= {0, 255}
