"""Each pytest worker builds the JAX package's native libraries into a
cache of its own.

`adder_tpu/ops/native_build.py` (and the entropy library's build in
`adder_tpu/codec/compressed.py`) compile every process into the same
`libadder_<name>.so.tmp` of the shared cache. When two xdist workers build
one library at once, one worker's rename fails, its loader caches None, and
every native test of that worker skips. The loaders honour
`ADDER_TPU_NATIVE_CACHE` (`native_build.py:23-32`), so this module points
it at `.cache/native-<worker>` unless the caller has set it. Every worker
imports every test file while collecting, before any test runs, and no
test file builds a native library at import, so setting it here, at
import, reaches every build of the run.
"""

import os
import pathlib
import re

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
WORKER = os.environ.get("PYTEST_XDIST_WORKER", "main")
os.environ.setdefault("ADDER_TPU_NATIVE_CACHE",
                      str(REPO / ".cache" / f"native-{WORKER}"))


def test_native_cache_is_the_workers_own():
    from adder_tpu.ops import native_build

    cache = native_build._cache_dir()
    assert cache == pathlib.Path(os.environ["ADDER_TPU_NATIVE_CACHE"])
    assert cache.is_dir()


@pytest.mark.parametrize("module,name", [
    ("adder_tpu.framer.native_ingest", "framer_fill"),
    ("adder_tpu.ops.native_dvs_plan", "dvs_plan"),
    ("adder_tpu.ops.native_assemble", "assemble"),
])
def test_jax_native_library_loads_in_this_worker(module, name):
    import importlib

    mod = importlib.import_module(module)
    assert mod._get_lib() is not None, f"{name} did not load"
    cache = pathlib.Path(os.environ["ADDER_TPU_NATIVE_CACHE"])
    assert (cache / f"libadder_{name}.so").exists()


def test_no_test_file_builds_a_native_library_at_import():
    """A build started while a file is imported would run before this
    module sets the cache: every native loader is called inside a test or a
    fixture, never at a test file's top level."""
    loader = re.compile(r"(_get_lib|native_build\.load|_build_library|"
                        r"_load_native)\(")
    offenders = []
    for path in sorted((REPO / "tests").glob("*.py")):
        for line in path.read_text().splitlines():
            if line and not line[0].isspace() and loader.search(line):
                offenders.append(f"{path.name}: {line.strip()}")
    assert offenders == []
