"""The kernel build (``repro_torch._build``) on the CPU, with a stand-in
``nvcc`` that writes its output file and a ptxas-like report: every
``csrc/*.cu`` is compiled once with the build's flags, each compile's time
and report are logged, the objects are linked into one library named by the
sources' hash, and a failing compile raises naming its source."""
import _torch_threads  # noqa: F401  (first: one CPU thread)
import os
import re
import stat
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from repro_torch import _build  # noqa: E402

FAKE_NVCC = """#!{python}
import sys, time
args = sys.argv[1:]
time.sleep({delay})
with open({log!r}, "a") as f:
    f.write(" ".join(args) + "\\n")
if "-c" in args and args[args.index("-c") + 1].endswith({fail!r}):
    print("error: refused")
    sys.exit(1)
open(args[args.index("-o") + 1], "w").close()
print("ptxas info    : Used 1 registers")
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    def make(fail="never", delay=0.0):
        log = tmp_path / "calls.log"
        nvcc = tmp_path / "cuda" / "bin" / "nvcc"
        nvcc.parent.mkdir(parents=True, exist_ok=True)
        nvcc.write_text(FAKE_NVCC.format(python=sys.executable, log=str(log),
                                         fail=fail, delay=delay))
        nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
        monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
        monkeypatch.setattr(_build, "BUILD_LOG", [])
        return log
    return make


def test_build_compiles_each_source_once_and_links_one_library(fake_nvcc):
    log = fake_nvcc()
    target = _build.build()
    assert target == _build.library_path() and target.exists()
    calls = log.read_text().splitlines()
    compiled = sorted(c.split(" -c ")[1].split()[0] for c in calls
                      if " -c " in c)
    assert compiled == sorted(map(str, _build.sources()))
    assert all(" ".join(_build.FLAGS) in c for c in calls if " -c " in c)
    links = [c for c in calls if "-shared" in c]
    assert len(links) == 1
    assert sum(".o" in a for a in links[0].split()) == len(compiled)
    headers = sorted(e.splitlines()[0] for e in _build.BUILD_LOG)
    assert [h.split()[1] for h in headers] == sorted(
        s.name for s in _build.sources())
    assert all(re.fullmatch(r"== \S+\.cu \(\d+\.\d\d s\)", h)
               for h in headers)
    assert all("Used 1 registers" in e for e in _build.BUILD_LOG)
    # an unchanged tree reuses the library
    assert _build.build() == target
    assert len(log.read_text().splitlines()) == len(calls)


def test_build_raises_naming_the_source_that_failed(fake_nvcc):
    fake_nvcc(fail="flash_tc.cu")
    with pytest.raises(RuntimeError, match="flash_tc.cu"):
        _build.build()
    assert not _build.library_path().exists()


BUILD_IN_CHILD = """
import sys
from pathlib import Path
from repro_torch import _build
_build.BUILD_DIR = Path(sys.argv[1])
print(_build.build())
"""


def test_two_processes_on_a_fresh_tree_build_once(fake_nvcc, tmp_path):
    """Two processes (as two ranks of a sharded run) call ``build()`` on a
    fresh tree at once: the build lock makes the second wait and reuse the
    first's library, so every source is compiled once and linked once."""
    log = fake_nvcc(delay=0.2)
    src = os.path.join(os.path.dirname(_build.PKG_DIR), "")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=src)
    build_dir = str(tmp_path / "build")
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_IN_CHILD,
                               build_dir], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1] for o in outs]
    paths = {o[0].strip() for o in outs}
    assert len(paths) == 1 and os.path.exists(paths.pop())
    calls = log.read_text().splitlines()
    compiled = [c for c in calls if " -c " in c]
    assert len(compiled) == len(_build.sources())
    assert sum("-shared" in c for c in calls) == 1
