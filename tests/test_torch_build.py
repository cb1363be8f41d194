"""The kernel build's publishing, with a stand-in for ``nvcc``.

``repro_torch.kernels.build`` compiles in a private directory and renames
it into ``build/kernels-<hash>/``.  The stand-in compiler writes each
object in two halves with a pause between, and its linker refuses an
object that is not whole, so builds that shared their objects would fail
here.  No CUDA toolkit is needed.
"""
import re
import sys
import threading

import pytest

from repro_torch.kernels import build
from repro_torch.launch import kernel_variants

FAKE_NVCC = """\
import sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
if "-c" in args:
    src = args[args.index("-c") + 1]
    if "FAIL" in open(src).read():
        sys.exit("error: refused")
    with open(out, "w") as f:
        f.write("begin " + src + " " + " ".join(a for a in args if a.startswith("-D")) + "\\n")
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


def test_defines_build_a_variant_of_its_own(fake_toolchain):
    lib = build.build()
    variant = build.build(("DICE_FFN_STAGES=3", "DICE_TF32_ONE_PASS"))
    assert variant.parent != lib.parent
    assert variant.parent == build.build_dir(("DICE_FFN_STAGES=3", "DICE_TF32_ONE_PASS"))
    obj = (variant.parent / "expert_ffn.o").read_text()
    assert "-DDICE_FFN_STAGES=3 -DDICE_TF32_ONE_PASS" in obj
    assert "-D" not in (lib.parent / "expert_ffn.o").read_text()
    assert build.build() == lib                   # the port's library is untouched


@pytest.mark.parametrize("name", [n for n, (_, d) in kernel_variants.VARIANTS.items() if d])
def test_variant_macros_reach_only_their_own_build(fake_toolchain, name):
    """Each design alternative of launch/kernel_variants.py compiles every
    source with its -D macros, in a directory of its own; the port's
    library is compiled with none."""
    defines = kernel_variants.VARIANTS[name][1]
    variant = build.build(defines)
    lib = build.build()
    flags = " ".join(f"-D{d}" for d in defines)
    for src in build.SOURCES:
        obj = src.replace(".cu", ".o")
        assert (variant.parent / obj).read_text().split("\n")[0].endswith(flags)
        assert "-D" not in (lib.parent / obj).read_text()


PTXAS_LOG = """\
== expert_ffn.cu (rc 0)
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN4dice46_GLOBAL__N__b4631135_13_expert_ffn_cu_d0de499214gate_up_kernelIfEEvPKT_S4_S4_Pfiiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN4dice46_GLOBAL__N__b4631135_13_expert_ffn_cu_d0de499214gate_up_kernelIfEEvPKT_S4_S4_Pfiiiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers
ptxas info    : Compile time = 338.387 ms

== flash_attention.cu (rc 0)
ptxas info    : Compiling entry function '_ZN4dice51_GLOBAL__N__04cf38d3_18_flash_attention_cu_1d39a69712flash_kernelI13__nv_bfloat16Li32EEEvPKT_S5_S5_PS3_iiiiiNS0_7StridesES7_S7_S7_iiiiffi' for 'sm_90a'
ptxas info    : Used 252 registers, used 1 barriers
"""


def test_ptxas_report_labels_each_kernel(fake_toolchain):
    out = build.build_dir(("DICE_FLASH_WARPS=4",))
    out.mkdir(parents=True)
    (out / "build.log").write_text(PTXAS_LOG)
    assert build.ptxas_report(("DICE_FLASH_WARPS=4",)) == [
        "== expert_ffn.cu (rc 0)",
        "gate_up<f32>: 0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "gate_up<f32>: ptxas info    : Used 255 registers, used 1 barriers",
        "== flash_attention.cu (rc 0)",
        "flash<bf16, 32>: ptxas info    : Used 252 registers, used 1 barriers"]


SASS = """\
\t\tFunction : _ZN4dice12_GLOBAL__N_116bwd_wgmma_kernelILi3EEEvNS0_4MapsENS0_7BwdArgsE
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0a40*/                   HGMMA.64x128x8.F32.TF32 R24, R152, gdesc[UR4], R24, gsb0 ;
        /*0a50*/                   HGMMA.64x128x8.F32.TF32 R24, R156, gdesc[UR8], R24, gsb0 ;
        /*0a60*/                   FFMA R3, R4, R5, R3 ;
\t\tFunction : _ZN4dice12_GLOBAL__N_119flash_bwd_dkdv_kernelILi9EEEvPKfS3_S3_S3_S3_S3_PfS4_iiiiNS0_7StridesES5_S5_S5_fi
        /*0100*/                   HMMA.1688.F32.TF32 R8, R12, R16, R8 ;
        /*0110*/              @!P0 FFMA R3, R4, R5, R3 ;
\t\tFunction : some_other_kernel
        /*0100*/                   HMMA.1688.F32.TF32 R8, R12, R16, R8 ;
"""


def test_sass_opcodes_counts_each_kernels_tensor_core_instructions(fake_toolchain):
    """The check that the backward kernels' products are on the tensor
    cores reads cuobjdump's SASS: HGMMA (wgmma) and HMMA (mma.sync) lines
    counted per kernel, labelled as ptxas_report labels them."""
    cuobjdump = fake_toolchain / "cuobjdump"
    listing = fake_toolchain / "sass.txt"
    listing.write_text(SASS)
    cuobjdump.write_text(f"#!{sys.executable}\nprint(open({str(listing)!r}).read())\n")
    cuobjdump.chmod(0o755)
    assert build.sass_opcodes(("HGMMA", "HMMA", "FFMA")) == {
        "bwd_wgmma<3>": {"HGMMA": 2, "HMMA": 0, "FFMA": 1},
        "flash_bwd_dkdv<9>": {"HGMMA": 0, "HMMA": 1, "FFMA": 1}}


def test_every_source_and_entry_point_is_registered():
    """Each .cu under csrc/ is compiled, each header is hashed, and each
    C entry point the wrappers call has its ctypes signature (the RWKV-6
    backward's: 15 pointers, B, H, T, DK, 15 strides, 3 dtypes, device,
    stream)."""
    assert sorted(build.SOURCES) == sorted(p.name for p in build.CSRC.glob("*.cu"))
    assert sorted(build.HEADERS) == sorted(p.name for p in build.CSRC.glob("*.cuh"))
    assert "rwkv6_scan_bwd.cu" in build.SOURCES
    sig = build.SIGNATURES["dice_rwkv6_scan_bwd"]
    assert len(sig) == 15 + 4 + 15 + 4 + 1
    assert sig[15:19] == [build._I] * 4 and sig[19:34] == [build._L] * 15
    for src in build.SOURCES:
        text = (build.CSRC / src).read_text()
        for name in re.findall(r'extern "C" int (\w+)\(', text):
            assert name in build.SIGNATURES, (src, name)


@pytest.mark.parametrize("mangled,label", [
    ("_ZN4dice12_GLOBAL__N_121rwkv6_scan_bwd_kernelILi64EEEvNS0_7BwdArgsE",
     "rwkv6_scan_bwd<64>"),
    ("_ZN4dice46_GLOBAL__N__0a1b2c3d_13_rwkv6_scan_cu_1122334417rwkv6_scan_kernelILi64EEEvNS0_"
     "8ScanArgsEPKvPKfPfSA_iii", "rwkv6_scan<64>"),
    ("_ZN4dice12_GLOBAL__N_121rwkv6_scan_bwd_kernelI13__nv_bfloat16Li64EEEvNS0_9ChunkArgsE",
     "rwkv6_scan_bwd<bf16, 64>"),
    ("_ZN4dice12_GLOBAL__N_121rwkv6_scan_bwd_kernelIfLi128EEEvNS0_9ChunkArgsE",
     "rwkv6_scan_bwd<f32, 128>"),
    ("_ZN4dice12_GLOBAL__N_128rwkv6_scan_bwd_finish_kernelEPfPKfS3_S3_Pviiiii",
     "rwkv6_scan_bwd_finish")])
def test_kernel_labels_tell_the_scan_from_its_backward(mangled, label):
    assert build._kernel_label(mangled) == label


@pytest.mark.parametrize("mangled,label", [
    ("_ZN4dice12_GLOBAL__N_119flash_bwd_dq_kernelI13__nv_bfloat16Li32ELb1EEEvPKT_S5_",
     "flash_bwd_dq<bf16, 32, masks>"),
    ("_ZN4dice12_GLOBAL__N_121flash_bwd_dkdv_kernelIfLi20ELb0EEEvPKT_S4_",
     "flash_bwd_dkdv<f32, 20>"),
    ("_ZN4dice12_GLOBAL__N_116bwd_wgmma_kernelILi2E13__nv_bfloat16EEvNS0_4MapsENS0_7BwdArgsE",
     "bwd_wgmma<2, bf16>"),
    ("_ZN4dice12_GLOBAL__N_116bwd_wgmma_kernelILi0EfEEvNS0_4MapsENS0_7BwdArgsE",
     "bwd_wgmma<0, f32>"),
    ("_ZN4dice12_GLOBAL__N_112widen_kernelEPK13__nv_bfloat16Pfx", "widen")])
def test_kernel_labels_tell_the_masked_and_bf16_instances(mangled, label):
    """The flash backward's instances with the window and softcap masks
    and the expert backward's bf16-output passes get labels of their own
    in ptxas's report and the SASS counts."""
    assert build._kernel_label(mangled) == label


@pytest.mark.parametrize("name,group", [
    ("void dice::(anonymous namespace)::rwkv6_scan_bwd_kernel<__nv_bfloat16, 64>"
     "(dice::(anonymous namespace)::ChunkArgs)", "rwkv6_scan_bwd"),
    ("dice::(anonymous namespace)::rwkv6_scan_bwd_finish_kernel(float*, float const*, "
     "float const*, float const*, void*, int, int, int, int, int)", "rwkv6_scan_bwd"),
    ("void dice::(anonymous namespace)::rwkv6_scan_kernel<64>(dice::(anonymous "
     "namespace)::ScanArgs, void const*, float const*, float*, float*, int, int, int)",
     "rwkv6_scan")])
def test_profiles_group_both_launches_of_the_scan_backward(name, group):
    """profile_serve and profile_train put each kernel the backward
    launches (the chunked recurrence, then its finish) in its group, and
    the forward in its own."""
    from repro_torch.launch.profile_serve import kernel_group
    assert kernel_group(name) == group
