"""Card-only tests: the compiled Triton kernels against the reference on a
GPU, through the same checks `chip_smoke.py` runs (at smaller widths).

They skip without a card.  On a GPU machine:
    MINI3DGS_TEST_GPU=1 python -m pytest tests/test_gpu.py -m gpu
"""

import pytest

from mini3dgs_tpu import checks

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("aniso,w,h,tile", [(False, 256, 256, 32),
                                            (True, 256, 256, 16),
                                            (True, 200, 136, 16)])
def test_compiled_kernels_match_reference(gpu, aniso, w, h, tile):
    g, cam = checks.population(2 ** 13, 6000, w, h, aniso=aniso)
    calib = checks.calibrate(g, cam, checks.settings(w, h, tile, False),
                             rows=tile)
    st, _ = checks.sized_stream(g, cam, checks.settings(w, h, tile, True))
    checks.kernel_parity(g, cam, st, calib,
                         skip={} if aniso else checks.ISOTROPIC_SKIP)


def test_compiled_t0_split_matches_single_pass(gpu):
    g, cam = checks.population(2 ** 13, 6000, 256, 256)
    st, _ = checks.sized_stream(g, cam, checks.settings(256, 256, 16, True))
    checks.t0_split_parity(g, cam, st)
