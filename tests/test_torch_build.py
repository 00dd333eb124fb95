"""The kernel build (celestia_app_tpu_torch/cuda_build.py) with a stand-in
compiler: one process per missing library, nothing rebuilt when the
source is unchanged, and a failed compile raised, never swallowed."""

import stat

import pytest

from celestia_app_tpu_torch import cuda_build

_FAKE_NVCC = """#!/bin/sh
echo "$@" >> "$(dirname "$0")/calls"
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then shift; echo built > "$1"; fi
  shift
done
echo "ptxas info    : Used 10 registers"
"""


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    return tmp_path


def _fake(tmp_path, body: str) -> str:
    path = tmp_path / "nvcc"
    path.write_text(body)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def test_build_compiles_each_missing_source_once(build_dir, monkeypatch):
    nvcc = _fake(build_dir, _FAKE_NVCC)
    monkeypatch.setattr(cuda_build, "nvcc", lambda: nvcc)
    logs = cuda_build.build()
    assert sorted(logs) == sorted(cuda_build.SOURCES)
    assert all("registers" in log for log in logs.values())
    for name in cuda_build.SOURCES:
        assert cuda_build.library_path(name).read_text() == "built\n"
    calls = (build_dir / "calls").read_text().splitlines()
    assert len(calls) == len(cuda_build.SOURCES)
    assert all("arch=compute_90a,code=sm_90a" in c for c in calls)
    assert cuda_build.build() == {}  # unchanged sources: nothing rebuilt
    assert len((build_dir / "calls").read_text().splitlines()) == len(calls)


def test_failed_build_raises_and_leaves_no_library(build_dir, monkeypatch):
    nvcc = _fake(build_dir, "#!/bin/sh\necho 'error: expected a ;' \nexit 2\n")
    monkeypatch.setattr(cuda_build, "nvcc", lambda: nvcc)
    with pytest.raises(RuntimeError, match=r"sha256\.cu \(nvcc exit 2\)"):
        cuda_build.build(("sha256",))
    assert not cuda_build.library_path("sha256").exists()


def test_a_changed_header_rebuilds_the_kernels(build_dir, monkeypatch):
    """The library key covers the headers in csrc/ beside the source, so
    a kernel that includes a changed .cuh is rebuilt."""
    csrc = build_dir / "csrc"
    csrc.mkdir()
    for src in cuda_build.CSRC_DIR.iterdir():
        if src.suffix in (".cu", ".cuh"):
            (csrc / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(cuda_build, "CSRC_DIR", csrc)
    nvcc = _fake(build_dir, _FAKE_NVCC)
    monkeypatch.setattr(cuda_build, "nvcc", lambda: nvcc)
    assert sorted(cuda_build.build()) == sorted(cuda_build.SOURCES)
    before = {name: cuda_build.library_path(name) for name in cuda_build.SOURCES}
    headers = sorted(csrc.glob("*.cuh"))
    assert headers, "the kernels include no header"
    headers[0].write_text(headers[0].read_text() + "\n// changed\n")
    after = {name: cuda_build.library_path(name) for name in cuda_build.SOURCES}
    assert all(before[name] != after[name] for name in cuda_build.SOURCES)
    assert sorted(cuda_build.build()) == sorted(cuda_build.SOURCES)
    assert all(after[name].exists() for name in cuda_build.SOURCES)
    assert cuda_build.build() == {}
