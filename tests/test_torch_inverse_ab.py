"""The sampler's cluster-against-rows_kernel A/B tool
(``python -m dpfx_torch.tools.inverse_ab``) on the CPU, where every side is
the plain version: its lines for each shape and case (relu, another
activation, int8), the checks it holds each side to, and its refusals. No
JAX."""

import pytest

torch = pytest.importorskip("torch")

from dpfx_torch.tools import inverse_ab  # noqa: E402


def test_inverse_ab_lines_on_the_cpu(capsys):
    assert inverse_ab.main(["--device", "cpu", "--shape", "256:4", "--shape", "192:3", "--case",
                            "tanh", "--case", "relu+int8", "--b", "2", "--n", "40", "--k", "2",
                            "--turns", "2", "--reps", "1"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1] == "launches {}"
    timed = [ln for ln in out if "ms in turns" in ln]
    assert [ln.split(" B=")[0] for ln in timed] == [
        "H=256->256 n_hidden=4 tanh", "H=256->256 n_hidden=4 relu int8",
        "H=192->256 n_hidden=3 tanh", "H=192->256 n_hidden=3 relu int8"]
    assert all("tree cluster" in ln and "tree rows" in ln and ln.endswith("(cpu)") for ln in timed)
    held = [ln for ln in out if "against the plain inverse of its noise" in ln]
    assert len(held) == 4 and all("repeats its bits True" in ln for ln in held)
    assert all("int8 = bf16 on the dequantized stacks True" in ln for ln in held if "int8" in ln)


@pytest.mark.parametrize("args", [["--case", "swish"], ["--case", "relu+int4"],
                                  ["--shape", "256"], ["--variant", "tree=build/x"]])
def test_inverse_ab_refuses_bad_arguments(args):
    with pytest.raises(SystemExit):
        inverse_ab.main(["--device", "cpu", *args])


def test_inverse_ab_builds_variants_for_the_card_only(capsys):
    assert inverse_ab.main(["--device", "cpu", "--variant", "v=build/none", "--b", "1", "--n", "8",
                            "--k", "1"]) == 1
    assert "card only" in capsys.readouterr().err
