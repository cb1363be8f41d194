"""The kernel build's publishing, with a stand-in for ``nvcc``.

``repro_torch.kernels.build`` compiles in a private directory and renames
it into ``build/kernels-<hash>/``.  The stand-in compiler writes each
object in two halves with a pause between, and its linker refuses an
object that is not whole, so builds that shared their objects would fail
here.  No CUDA toolkit is needed.
"""
import sys
import threading

import pytest

from repro_torch.kernels import build

FAKE_NVCC = """\
import sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
if "-c" in args:
    src = args[args.index("-c") + 1]
    if "FAIL" in open(src).read():
        sys.exit("error: refused")
    with open(out, "w") as f:
        f.write("begin " + src + "\\n")
        f.flush()
        time.sleep(0.05)
        f.write("end\\n")
else:
    objs = [a for a in args if a.endswith(".o")]
    for o in objs:
        if not open(o).read().endswith("end\\n"):
            sys.exit("link: half-written object " + o)
    open(out, "w").write("linked %d objects\\n" % len(objs))
"""


@pytest.fixture
def fake_toolchain(tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\n" + FAKE_NVCC)
    nvcc.chmod(0o755)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in build.SOURCES + build.HEADERS:
        (csrc / name).write_text(f"// {name}\n")
    monkeypatch.setattr(build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "build")
    return tmp_path


def test_concurrent_builds_publish_one_whole_library(fake_toolchain):
    results, errors = [], []

    def run():
        try:
            results.append(build.build())
        except Exception as e:        # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=run) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert len(set(results)) == 1
    lib = results[0]
    assert lib == build.build_dir() / build.LIB_NAME
    assert lib.read_text() == f"linked {len(build.SOURCES)} objects\n"
    assert "== expert_ffn.cu (rc 0)" in (lib.parent / "build.log").read_text()
    # the private directories are gone; only the published one is left
    assert [p.name for p in (fake_toolchain / "build").iterdir()] == [lib.parent.name]
    assert build.build() == lib                   # reused, not rebuilt


def test_stale_partial_build_directory_is_replaced(fake_toolchain):
    out = build.build_dir()
    out.mkdir(parents=True)
    (out / "expert_ffn.o").write_text("begin, cut off")
    lib = build.build()
    assert lib.read_text().startswith("linked")
    assert not (out / "expert_ffn.o").read_text().startswith("begin, cut")


def test_failed_compile_raises_and_publishes_nothing(fake_toolchain):
    (fake_toolchain / "csrc" / "flash_attention.cu").write_text("FAIL\n")
    with pytest.raises(RuntimeError, match="flash_attention.cu"):
        build.build()
    assert list((fake_toolchain / "build").iterdir()) == []
