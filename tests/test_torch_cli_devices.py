"""``run --devices N`` through the port's command line against the JAX
CLI's on the CPU: the world's files (``chip_smoke.world_workload``, one
pair of each kind; bbduk, the hg and ribo filters, 2 NT shards) with
``-b``. The port runs on N places of the one CPU (``--devices 1`` rotates
the 2 NT shards through one place, ``2`` keeps both resident and aligns
them from the pool), the JAX package on N of conftest's virtual devices.
Both read the indexes the port's ``build-index`` wrote. Host seeding: the
JAX device walk compiles anew for each placement (~15-30 s);
``tests/test_torch_rotation.py`` rotates the port's device seeding. The
refusal of N above the visible cards is in ``tests/test_torch_cli.py``.
"""

import pytest

import chip_smoke as cs
from megapath_tpu import cli as jcli
from megapath_tpu_torch import cli
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)

CPU = ["--device", "cpu"]
OUTPUTS = (".nt.report", ".nt.ra.report", ".nt.lsam.id", ".nt.ra.lsam.id")
DEVICES = (1, 2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{(package, N): output prefix path} of ``run --devices N -b``."""
    d = tmp_path_factory.mktemp("devices")
    cs.write_world_files(cs.world_workload(n=1), d)
    for argv in cs.world_build_argvs(d):
        assert cli.main(argv + CPU) == 0
    out = {}
    for pkg, main, extra in (("port", cli.main, CPU), ("jax", jcli.main, [])):
        for n in DEVICES:
            out[pkg, n] = d / f"{pkg}{n}"
            argv = cs.world_run_argv(d, str(out[pkg, n]), False) + ["--devices", str(n)]
            assert main(argv + extra) == 0
    return out


@pytest.mark.parametrize("n", DEVICES)
def test_run_devices_outputs_byte_identical_to_jax(runs, n):
    for suf in OUTPUTS:
        got = runs["port", n].with_name(runs["port", n].name + suf).read_bytes()
        assert got == runs["jax", n].with_name(runs["jax", n].name + suf).read_bytes(), suf
        # the placement changes nothing
        assert got == runs["port", 3 - n].with_name(runs["port", 3 - n].name + suf).read_bytes()


@pytest.mark.parametrize("n", DEVICES)
def test_run_devices_bam_content_equals_jax(runs, n):
    for suf in (".nt.bam", ".nt.bam.0", ".nt.bam.1"):
        got = cs.bam_content(str(runs["port", n]) + suf)
        assert got == cs.bam_content(str(runs["jax", n]) + suf), suf
    assert got[1]
