"""The reference-recipe runners of the port (scripts/torch_run_roargraph_
test.sh, scripts/torch_run_roargraph_search_test.sh): each parses
(``bash -n``), runs the same commands with the same flags as its JAX twin
(``msann-<name>`` becomes ``python -m mysteryann_tpu_torch.cli.<name>``),
and every flag is accepted by that CLI's own parser. Nothing is downloaded
or run: the parser stops each CLI right after parsing."""

import argparse
import importlib
import os
import shlex
import subprocess

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIRS = [("torch_run_roargraph_test.sh", "run_roargraph_test.sh"),
         ("torch_run_roargraph_search_test.sh",
          "run_roargraph_search_test.sh")]
PORT_PREFIX = ["python", "-m"]


def _commands(name):
    """The script's command lines as argv lists (continuations joined,
    the data-directory variables expanded to their defaults)."""
    with open(os.path.join(ROOT, "scripts", name)) as f:
        text = f.read().replace("\\\n", " ")
    text = text.replace("${DATA_DIR:-data}", "data").replace(
        "$data", "data/t2i-10M")
    out = []
    for line in text.splitlines():
        words = shlex.split(line, comments=True)
        if words and (words[0].startswith("msann-") or words[:2] == PORT_PREFIX):
            out.append(words)
    return out


class _Parsed(Exception):
    pass


def _parse_with_cli(module, argv):
    """The namespace the CLI's own parser makes of ``argv``; the CLI does
    nothing else."""
    real = argparse.ArgumentParser.parse_args

    def stop(self, args=None, namespace=None):
        raise _Parsed(real(self, args, namespace))

    mod = importlib.import_module(f"mysteryann_tpu_torch.cli.{module}")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", stop)
        with pytest.raises(_Parsed) as e:
            mod.main(argv)
    return e.value.args[0]


@pytest.mark.parametrize("port,jax", PAIRS)
def test_script_parses(port, jax):
    r = subprocess.run(["bash", "-n", os.path.join(ROOT, "scripts", port)],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    assert os.access(os.path.join(ROOT, "scripts", port), os.X_OK)


@pytest.mark.parametrize("port,jax", PAIRS)
def test_same_recipe_as_the_jax_script(port, jax):
    ported, reference = _commands(port), _commands(jax)
    assert ported and len(ported) == len(reference)
    for p, j in zip(ported, reference):
        assert p[2] == "mysteryann_tpu_torch.cli." + \
            j[0][len("msann-"):].replace("-", "_")
        assert p[3:] == j[1:]


@pytest.mark.parametrize("port", [p for p, _ in PAIRS])
def test_flags_are_the_clis_own(port):
    for argv in _commands(port):
        module = argv[2].rsplit(".", 1)[1]
        ns = _parse_with_cli(module, argv[3:])
        if module == "build_roargraph":
            assert (ns.M_sq, ns.M_pjbp, ns.L_pjpq) == (100, 35, 500)
            assert ns.learn_base_nn_path == "data/t2i-10M/learn.base.nn.ibin"
        if module == "search_roargraph":
            assert ns.k == 10 and ns.L_pq[0] == 10 and ns.L_pq[-1] == 2000
            assert len(ns.L_pq) == 41
        if module == "compute_gt":
            assert (ns.k, ns.format, ns.dist) == (100, "knn", "ip")
        if module == "prepare_data":
            assert ns.dataset == "t2i-10M" and ns.data_dir == "data"
