"""Where the program keeps its build products and which device it measures
on: the compile-cache placement, the native library's build key, and the
device checks of chip_smoke.py and bench.py (which refuse the CPU)."""
import os
import shutil
import subprocess
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


class TestCompileCache:
    def test_env_var_wins(self, monkeypatch, tmp_path):
        from lssp_tpu.utils.profile import compile_cache_dir
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert compile_cache_dir() == str(tmp_path)

    def test_default_is_in_checkout(self, monkeypatch):
        from lssp_tpu.utils.profile import compile_cache_dir
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert compile_cache_dir() == os.path.join(ROOT, ".jax_cache")
        with open(os.path.join(ROOT, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()

    @pytest.mark.parametrize("env_set", [True, False], ids=["set", "unset"])
    def test_enable_sets_only_the_default(self, monkeypatch, tmp_path,
                                          env_set):
        """With the variable set, JAX reads it itself and no directory is
        set in code; unset, the in-checkout directory is set."""
        from lssp_tpu.utils import profile
        calls = {}
        monkeypatch.setattr(jax.config, "update",
                            lambda k, v: calls.__setitem__(k, v))
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            monkeypatch.setattr(profile, "_DEFAULT_CACHE_DIR",
                                str(tmp_path / "cache"))
        got = profile.enable_persistent_cache()
        if env_set:
            assert got == str(tmp_path)
            assert "jax_compilation_cache_dir" not in calls
        else:
            assert got == str(tmp_path / "cache") and os.path.isdir(got)
            assert calls["jax_compilation_cache_dir"] == got


class TestNativeBuildKey:
    def test_key_tracks_sources_flags_and_arch(self, tmp_path, monkeypatch):
        from lssp_tpu import native
        src = tmp_path / "a.cpp"
        src.write_text("int f() { return 1; }\n")
        k0 = native.build_key([str(src)], ("-O3",))
        assert k0 == native.build_key([str(src)], ("-O3",))
        assert k0 != native.build_key([str(src)], ("-O2",))
        src.write_text("int f() { return 2; }\n")
        assert k0 != native.build_key([str(src)], ("-O3",))
        monkeypatch.setattr(native.platform, "machine", lambda: "other")
        src.write_text("int f() { return 1; }\n")
        assert k0 != native.build_key([str(src)], ("-O3",))

    def test_library_path_carries_key_and_portable_flags(self):
        from lssp_tpu import native
        assert native.build_key() in os.path.basename(native.lib_path())
        assert not any(f.startswith("-march") for f in native._FLAGS)
        with open(os.path.join(ROOT, ".gitignore")) as f:
            assert "lssp_tpu/native/_build/" in f.read().split()


class TestDeviceChecks:
    def test_device_stamp_rejects_cpu(self):
        from lssp_tpu.utils.device import device_stamp
        assert jax.devices()[0].platform == "cpu"
        with pytest.raises(RuntimeError, match="no GPU"):
            device_stamp()

    def test_chip_smoke_device_phase_rejects_cpu(self):
        import chip_smoke
        with pytest.raises(RuntimeError, match="no GPU"):
            chip_smoke.phase_device()

    def test_chip_smoke_alone_fails_without_result(self, tmp_path):
        """Copied into a directory with nothing else of the repo, the
        script exits non-zero and prints no result line."""
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        env = dict(os.environ, PYTHONPATH="")
        out = subprocess.run([sys.executable, "chip_smoke.py"],
                             cwd=tmp_path, env=env, capture_output=True,
                             text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout

    def test_bench_peak_table_refuses_unknown_device(self):
        import bench
        assert bench.peak_hbm_gbps("NVIDIA H100 80GB HBM3") == 3350.0
        with pytest.raises(KeyError, match="no published HBM peak"):
            bench.peak_hbm_gbps("cpu")
