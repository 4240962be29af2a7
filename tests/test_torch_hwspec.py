"""The port's hardware model against the JAX package's.

``repro_torch.sharding.segments`` and ``repro_torch.hwspec`` are copies of
the JAX package's: every preset cluster is held against the original pool
by pool and slice by slice (names, costs, streams, devices, fractions,
shapes, MIG memory slots and starts, budgets, prices, failure domains), and
the segment catalogue entry by entry.  The port's own H100 presets
(``H100_SXM``, ``H100_MIG_PROFILES``, ``h100_cluster``) have no original;
they are pinned to the H100 SXM5 datasheet and to the MIG user guide's
profile table, and ``MigSlicePacker`` is checked on one H100.
"""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro import hwspec as jhw  # noqa: E402
from repro.core import hw as jax_hw_shim  # noqa: E402
from repro.sharding import segments as jseg  # noqa: E402

from repro_torch import hwspec as phw  # noqa: E402
from repro_torch.core import hw as port_hw_shim  # noqa: E402
from repro_torch.core.placement import MigSlicePacker, make_placer  # noqa: E402
from repro_torch.sharding import segments as pseg  # noqa: E402

PRESETS = ("default_cluster", "hetero_cluster", "tight_hetero_cluster",
           "chaos_cluster")


def _scheme_fields(scheme):
    """Everything a scheme tells the profiler, planner and packers."""
    return dict(kind=type(scheme).__name__,
                fields=dataclasses.asdict(scheme),
                units_per_device=scheme.units_per_device,
                unopt_cost=scheme.unopt_cost,
                repartition_delay_s=scheme.repartition_delay_s,
                repartition_blocks=scheme.repartition_blocks,
                slices=[dataclasses.asdict(s) for s in scheme.slices()])


def _pool_fields(pool):
    return dict(name=pool.name, count=pool.count,
                slice_price=pool.slice_price, domains=pool.domains,
                device=dataclasses.asdict(pool.device),
                staging_bw=pool.device.staging_bw,
                usable_hbm_bytes=pool.device.usable_hbm_bytes,
                capacity_units=pool.capacity_units,
                domain_units=pool.domain_units(),
                scheme=_scheme_fields(pool.scheme))


@pytest.mark.parametrize("preset", PRESETS)
def test_preset_clusters_are_copies(preset):
    """Each preset, pool by pool and slice by slice, equals the JAX
    package's, with the same derived budgets, prices and domains."""
    want, got = getattr(jhw, preset)(), getattr(phw, preset)()
    assert len(got.pools) == len(want.pools)
    for gp, wp in zip(got.pools, want.pools):
        assert _pool_fields(gp) == _pool_fields(wp)
    assert got.total_units == want.total_units
    assert got.budgets() == want.budgets()
    assert got.prices() == want.prices()
    assert got.domain_names == want.domain_names
    assert got.domain_units() == want.domain_units()
    for p in want.pools:
        for s in p.scheme.slices():
            gpool, gsl = got.find_slice(s.name)
            assert gpool.name == p.name
            assert dataclasses.asdict(gsl) == dataclasses.asdict(s)


@pytest.mark.parametrize("kind", ["v5e", "a100", "a100_profiles", "shim"])
def test_device_presets_are_copies(kind):
    if kind == "v5e":
        assert (dataclasses.asdict(phw.TPU_V5E)
                == dataclasses.asdict(jhw.TPU_V5E))
    elif kind == "a100":
        assert (dataclasses.asdict(phw.A100_40GB)
                == dataclasses.asdict(jhw.A100_40GB))
    elif kind == "a100_profiles":
        from repro.hwspec.partition import A100_MIG_PROFILES as want
        assert ([dataclasses.asdict(p) for p in phw.A100_MIG_PROFILES]
                == [dataclasses.asdict(p) for p in want])
        assert (_scheme_fields(phw.MigScheme())
                == _scheme_fields(jhw.MigScheme()))
    else:
        names = [n for n in dir(jax_hw_shim) if n.isupper()]
        assert names
        for n in names:
            got, want = getattr(port_hw_shim, n), getattr(jax_hw_shim, n)
            if dataclasses.is_dataclass(want):
                got, want = dataclasses.asdict(got), dataclasses.asdict(want)
            assert got == want, n
        assert port_hw_shim.peak_flops("int8") == jax_hw_shim.peak_flops(
            "int8")
        assert port_hw_shim.param_bytes("int8") == 1
        assert port_hw_shim.param_bytes("bf16") == 2
    assert phw.DEFAULT_POOL == jhw.DEFAULT_POOL == "v5e"


@pytest.mark.parametrize("args", [
    dict(), dict(max_chips=8), dict(max_chips=4, max_streams=2),
    dict(spatial=False), dict(spatial=False, unopt_chips=16),
    dict(max_chips=64, max_streams=1)], ids=str)
def test_segment_catalogue_is_a_copy(args):
    want, got = jseg.catalogue(**args), pseg.catalogue(**args)
    assert ([dataclasses.asdict(s) for s in got]
            == [dataclasses.asdict(s) for s in want])
    assert [(s.name, s.cost) for s in got] == [(s.name, s.cost) for s in want]
    for s in want:
        if args.get("spatial", True) and s.chips <= 64:
            assert (dataclasses.asdict(pseg.by_name(s.name))
                    == dataclasses.asdict(jseg.by_name(s.name)))
        assert (dataclasses.asdict(phw.slice_from_segment(
            pseg.SegmentType(s.chips, s.streams, s.shape)))
            == dataclasses.asdict(jhw.slice_from_segment(s)))
    assert pseg.SEGMENT_SHAPES == jseg.SEGMENT_SHAPES
    assert pseg.MAX_STREAMS == jseg.MAX_STREAMS
    with pytest.raises(KeyError):
        pseg.by_name("3x3s1")


def test_h100_device_pinned_to_datasheet():
    """H100 SXM5 80GB, dense figures: 989 TFLOP/s bf16, 1,979 TOPS int8,
    80 GB at 3.35 TB/s, 900 GB/s NVLink; the calibration keeps the
    reference's defaults."""
    d = phw.H100_SXM
    assert d.name == "h100-sxm"
    assert dict(d.peak_flops) == {"bf16": 989e12, "int8": 1979e12}
    assert d.peak("fp8") == 989e12          # unknown dtypes fall back to bf16
    assert d.hbm_bytes == 80 * 10 ** 9
    assert d.hbm_bw == 3.35e12
    assert d.ici_bw_per_link == 900e9
    default = phw.DeviceSpec("x", {"bf16": 1.0}, 1, 1.0, 1.0)
    for f in ("hbm_usable_fraction", "flops_efficiency", "hbm_efficiency",
              "ici_efficiency", "weight_load_bw"):
        assert getattr(d, f) == getattr(default, f), f
    assert d.staging_bw == d.hbm_bw / 256.0
    assert d.usable_hbm_bytes == 80 * 10 ** 9 * 0.9


def test_h100_mig_profiles_pinned_to_user_guide():
    """NVIDIA's MIG profiles of the H100 80GB (7 g-units, 8 memory slots),
    the ``+me`` variants left out."""
    got = [(p.name, p.g, p.mem_slots, p.starts)
           for p in phw.H100_MIG_PROFILES]
    assert got == [("1g.10gb", 1, 1, (0, 1, 2, 3, 4, 5, 6)),
                   ("1g.20gb", 1, 2, (0, 2, 4, 6)),
                   ("2g.20gb", 2, 2, (0, 2, 4)),
                   ("3g.40gb", 3, 4, (0, 4)),
                   ("4g.40gb", 4, 4, (0,)),
                   ("7g.80gb", 7, 8, (0,))]
    for p in phw.H100_MIG_PROFILES:
        # the memory in the name is the slots' share of 80 GB
        assert int(p.name.split(".")[1][:-2]) == 10 * p.mem_slots


@pytest.mark.parametrize("devices", [1, 4])
def test_h100_cluster_geometry(devices):
    c = phw.h100_cluster(devices)
    (pool,) = c.pools
    assert pool.name == "h100" and pool.count == devices
    assert pool.device is phw.H100_SXM
    assert pool.scheme.profiles == phw.H100_MIG_PROFILES
    assert c.total_units == 7 * devices
    assert c.budgets() == {"h100": 7 * devices}
    assert c.prices() == {"h100": 1.0}
    assert c.domain_names == ()
    names = [s.name for s in pool.scheme.slices()]
    assert len(names) == 6 * pool.scheme.max_streams
    s = pool.scheme.slice("3g.40gb.s2")
    assert (s.cost, s.streams, s.devices, s.mem_slots, s.starts) == (
        3, 2, 1, 4, (0, 4))
    assert s.compute_fraction == 3 / 7 and s.memory_fraction == 4 / 8
    assert isinstance(make_placer(pool), MigSlicePacker)


@pytest.mark.parametrize("mix,fits", [
    (["1g.10gb"] * 7, True),
    (["1g.20gb"] * 4, True),
    (["2g.20gb"] * 3, True),
    (["4g.40gb", "3g.40gb"], True),
    (["7g.80gb"], True),
    (["1g.10gb"] * 8, False),
    (["4g.40gb"] * 2, False),
    (["1g.20gb"] * 5, False),
    (["7g.80gb", "1g.10gb"], False),
], ids=lambda v: "+".join(v) if isinstance(v, list) else str(v))
def test_mig_packer_on_one_h100(mix, fits):
    """The MIG rules on one card: a mix packs only if its compute fits 7
    g-units AND its memory slots fit aligned runs of the 8."""
    pool = phw.h100_cluster(1).pools[0]
    packer = make_placer(pool)
    pls = packer.pack([f"{n}.s1" for n in mix])
    if not fits:
        assert pls is None
        return
    assert pls is not None and len(pls) == len(mix)
    used = [0] * pool.scheme.total_mem_slots
    for pl in pls:
        sl = pool.scheme.slice(pl.segment)
        assert pl.pod == 0 and pl.pool == "h100"
        assert pl.row in sl.starts
        for r in range(pl.row, pl.row + sl.mem_slots):
            used[r] += 1
    assert max(used) == 1
    assert packer.g_total_used == sum(
        pool.scheme.slice(f"{n}.s1").cost for n in mix)
