"""Measurement entry points refuse a non-GPU device: bench.py and
chip_smoke.py exit non-zero with no result line on the CPU backend."""

import importlib.util
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_entry_{name}", os.path.join(ROOT, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("entry,argv", [("bench", None), ("chip_smoke", [])])
def test_entry_refuses_cpu(entry, argv, capsys):
    mod = _load(entry)
    with pytest.raises(SystemExit) as exc:
        mod.main() if argv is None else mod.main(argv)
    assert exc.value.code not in (0, None)
    assert "needs an NVIDIA GPU" in str(exc.value.code)
    assert '"ok"' not in capsys.readouterr().out
