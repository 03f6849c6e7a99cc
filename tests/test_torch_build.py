"""The kernel build (``repro_torch._build``) on the CPU, with a stand-in
``nvcc`` that writes its output file and a ptxas-like report: every
``csrc/*.cu`` is compiled once with the build's flags, each compile's time
and report are logged, the objects are linked into one library named by the
sources' hash, and a failing compile raises naming its source."""
import re
import stat
import sys

import pytest

pytest.importorskip("torch")

from repro_torch import _build  # noqa: E402

FAKE_NVCC = """#!{python}
import sys
args = sys.argv[1:]
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
    def make(fail="never"):
        log = tmp_path / "calls.log"
        nvcc = tmp_path / "cuda" / "bin" / "nvcc"
        nvcc.parent.mkdir(parents=True, exist_ok=True)
        nvcc.write_text(FAKE_NVCC.format(python=sys.executable, log=str(log),
                                         fail=fail))
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
