"""The port's copies of ``repro/core/{dataflow,planner,strategies,
perfmodel}.py`` give the reference's numbers exactly: every plan field by
field (tiling, dataflow, stages, partitions, traffic, local memory used,
reload factor) for every strategy on both hardware profiles, the traffic
and reload factor of every dataflow, the FPS ladder under the default and
the calibrated fit, the calibration fit itself and the decode roofline, on
ResNet20's conv GEMMs and on seeded random GEMMs, mirroring
``tests/test_planner.py`` and ``tests/test_perfmodel.py``. The modules are
plain Python on both sides, so equality is exact."""
import dataclasses
import re

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.configs.base import MemoryStrategy as JStrategy  # noqa: E402
from repro.configs.resnet20_cifar import CONFIG as JRESNET  # noqa: E402
from repro.core import dataflow as jdf  # noqa: E402
from repro.core import perfmodel as jpm  # noqa: E402
from repro.core import planner as jplan  # noqa: E402
from repro.core import strategies as jstrat  # noqa: E402
from repro.models.resnet import conv_layer_shapes as jshapes  # noqa: E402
from repro_torch.configs.base import MemoryStrategy as TStrategy  # noqa: E402
from repro_torch.configs.resnet20_cifar import CONFIG as TRESNET  # noqa: E402
from repro_torch.core import dataflow as tdf  # noqa: E402
from repro_torch.core import perfmodel as tpm  # noqa: E402
from repro_torch.core import planner as tplan  # noqa: E402
from repro_torch.core import strategies as tstrat  # noqa: E402
from repro_torch.models.resnet import conv_layer_shapes as tshapes  # noqa: E402

PROFILES = ["zcu104-tensil", "tpu-v5e"]
STRATEGIES = [s.value for s in JStrategy]


def _gemm_args(which):
    """(name, m, k, n, in_elems, out_elems) of the ResNet20 GEMMs (batch 1,
    as the ladder prices them, and 256) or of 25 seeded random GEMMs."""
    if which.startswith("resnet"):
        batch = int(which[len("resnet"):])
        assert jshapes(JRESNET, batch) == tshapes(TRESNET, batch)
        return [(n, m, k, nn, m * k // 9 if k % 9 == 0 else m * k, m * nn)
                for n, m, k, nn in tshapes(TRESNET, batch)]
    rng = np.random.default_rng(0)
    return [("g", int(m), int(k), int(n), 0, 0)
            for m, k, n in rng.integers(1, 8192, (25, 3))]


def _gemm(mod, args):
    name, m, k, n, in_elems, out_elems = args
    return mod.Gemm(name, m, k, n, in_elems=in_elems, out_elems=out_elems)


def _pair(args):
    return _gemm(jdf, args), _gemm(tdf, args)


def test_memory_strategy_names_equal():
    assert [s.value for s in TStrategy] == STRATEGIES
    assert [s.name for s in TStrategy] == [s.name for s in JStrategy]


@pytest.mark.parametrize("profile", PROFILES)
def test_hardware_profiles_equal(profile):
    assert (dataclasses.asdict(jstrat.HW_PROFILES[profile])
            == dataclasses.asdict(tstrat.HW_PROFILES[profile]))


@pytest.mark.parametrize("which", ["resnet1", "resnet256", "random"])
@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_plans_equal_field_by_field(which, profile, strategy):
    jcfg = jstrat.planner_config(JStrategy(strategy),
                                 jstrat.HW_PROFILES[profile])
    tcfg = tstrat.planner_config(TStrategy(strategy),
                                 tstrat.HW_PROFILES[profile])
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert (jstrat.mem_bandwidth(JStrategy(strategy),
                                 jstrat.HW_PROFILES[profile])
            == tstrat.mem_bandwidth(TStrategy(strategy),
                                    tstrat.HW_PROFILES[profile]))
    for args in _gemm_args(which):
        jg, tg = _pair(args)
        try:
            want = dataclasses.asdict(jplan.plan_gemm(jg, jcfg))
        except ValueError as err:
            with pytest.raises(ValueError, match=re.escape(str(err))):
                tplan.plan_gemm(tg, tcfg)
            continue
        got = tplan.plan_gemm(tg, tcfg)
        assert dataclasses.asdict(got) == want
        assert (got.arithmetic_intensity
                == jplan.plan_gemm(jg, jcfg).arithmetic_intensity)


@pytest.mark.parametrize("which", ["resnet1", "random"])
def test_traffic_and_reload_equal(which):
    for args in _gemm_args(which):
        jg, tg = _pair(args)
        for bm, bk, bn in ((128, 128, 128), (32, 64, 256), (512, 32, 32)):
            jt, tt = jdf.Tiling(bm, bk, bn), tdf.Tiling(bm, bk, bn)
            assert jt.grid(jg) == tt.grid(tg)
            for db in (False, True):
                assert jt.vmem_bytes(jg, db) == tt.vmem_bytes(tg, db)
            for df in jdf.DATAFLOWS:
                assert (jdf.traffic_bytes(jg, jt, df)
                        == tdf.traffic_bytes(tg, tt, df))
                assert (jdf.reload_factor(jg, jt, df)
                        == tdf.reload_factor(tg, tt, df))


@pytest.fixture(scope="module")
def resnet_gemms():
    args = _gemm_args("resnet1")
    return [_gemm(jdf, a) for a in args], [_gemm(tdf, a) for a in args]


@pytest.fixture(scope="module")
def fits(resnet_gemms):
    jg, tg = resnet_gemms
    return jpm.calibrate(jg), tpm.calibrate(tg)


def test_calibration_fit_equal(fits):
    jfit, tfit = fits
    assert dataclasses.asdict(jfit) == dataclasses.asdict(tfit)


@pytest.mark.parametrize("fit", ["default", "calibrated", "v5e"])
@pytest.mark.parametrize("profile", PROFILES)
def test_ladder_equal(resnet_gemms, fits, fit, profile):
    jg, tg = resnet_gemms
    jfit, tfit = {"default": (jpm.DEFAULT_FIT, tpm.DEFAULT_FIT),
                  "calibrated": fits,
                  "v5e": (jpm.V5E_FIT, tpm.V5E_FIT)}[fit]
    want = jpm.ladder(jg, jstrat.HW_PROFILES[profile], jfit)
    got = tpm.ladder(tg, tstrat.HW_PROFILES[profile], tfit)
    assert [dataclasses.asdict(r) for r in got] == [
        dataclasses.asdict(r) for r in want]


def test_calibrated_ladder_near_the_paper(resnet_gemms, fits):
    """The port's fit reproduces the paper's four FPS points within 10 %,
    as ``tests/test_perfmodel.py`` holds the reference's."""
    _, tg = resnet_gemms
    for r in tpm.ladder(tg, fit=fits[1]):
        assert abs(r.fps - tpm.PAPER_FPS[r.strategy]) \
            / tpm.PAPER_FPS[r.strategy] < 0.10


@pytest.mark.parametrize("n_params", [10**6, 2 * 10**9, 32 * 10**9])
def test_decode_roofline_equal(n_params):
    for bpp in (1, 2, 4):
        assert (jpm.decode_roofline(n_params, bytes_per_param=bpp)
                == tpm.decode_roofline(n_params, bytes_per_param=bpp))
    with pytest.raises(ValueError):
        tpm.decode_roofline(0)
