"""External-engine command lines of the port's workflow, against the JAX
package's (mirrors tests/test_external_argv.py).

* partis (partition and annotate) and ``get-linearham-info``: under the
  same recording stand-in for ``subprocess.run``, the port's workflow
  builds the JAX workflow's argv and keyword arguments.
* RevBayes: a fake ``rb`` records its argv and working directory, and the
  port's workflow then completes (``<rb> <outdir>/revbayes_run.rev`` run in
  the outdir, as the reference's ``rb $SOURCE``).
* The two workflow mains take the same option strings, apart from the
  port's ``--device``.
* A user template renders byte-equal through both packages, and an unknown
  field fails in both with the same KeyError.
"""

import argparse
import os
import stat

import pytest

import linearham_tpu.workflow as jax_wf
import linearham_tpu_torch.workflow as wf
from test_torch_pipeline import _make_tsv


class _Recorder:
    def __init__(self):
        self.calls = []

    def __call__(self, cmd, **kwargs):
        self.calls.append((list(cmd), kwargs))

        class R:
            returncode = 0
            stdout = ""
        return R()


def _partis_partition(mod, tmp_path):
    return mod.run_partis(str(tmp_path), "in.fasta", "/opt/partis/bin/partis")


def _partis_annotate(mod, tmp_path):
    return mod.run_partis(str(tmp_path), "x.fa", "partis", locus="igk",
                          parameter_dir="/params/", all_clonal_seqs=True)


def _get_linearham_info(mod, tmp_path):
    return mod.run_get_linearham_info("run.yaml", "partis", "run.lh.yaml",
                                      parameter_dir="/p/")


@pytest.mark.parametrize("call", [_partis_partition, _partis_annotate,
                                  _get_linearham_info])
def test_engine_argv_matches_jax(call, tmp_path, monkeypatch):
    seen = {}
    for name, mod in (("jax", jax_wf), ("port", wf)):
        rec = _Recorder()
        monkeypatch.setattr(mod.subprocess, "run", rec)
        out = call(mod, tmp_path)
        (cmd, kwargs), = rec.calls
        if "stdout" in kwargs:      # partis' log file: compare its name
            kwargs = dict(kwargs, stdout=kwargs["stdout"].name)
        seen[name] = (out, cmd, kwargs)
    assert seen["port"] == seen["jax"]
    assert seen["port"][2]["check"] is True


def test_revbayes_invocation_via_fake_binary(fixtures_dir, tmp_path,
                                             monkeypatch):
    monkeypatch.setenv("LINEARHAM_FAMILY_CACHE", "off")
    out = tmp_path / "wf"
    out.mkdir()
    staged = tmp_path / "staged.trees"
    _make_tsv(staged, n_rows=6, seed=2)
    rb = tmp_path / "fake_rb"
    rb.write_text("#!/bin/sh\n"
                  f"echo \"$@\" > {tmp_path}/rb_argv.log\n"
                  f"pwd > {tmp_path}/rb_cwd.log\n"
                  f"cp {staged} revbayes_run.trees\n")
    rb.chmod(rb.stat().st_mode | stat.S_IEXEC)
    wf.run_family_workflow(
        str(out), partis_yaml_file=str(fixtures_dir / "phylo_hmm_input.yaml"),
        hmm_param_dir=str(fixtures_dir / "hmm_params"), mcmc_iter=10,
        mcmc_thin=1, tune_iter=0, tune_thin=1, num_rates=4, burnin_frac=0.0,
        subsamp_frac=0.5, seed=0, rb_binary=str(rb), device="cpu")
    assert (tmp_path / "rb_argv.log").read_text().split() == [
        str(out / "revbayes_run.rev")]
    assert (tmp_path / "rb_cwd.log").read_text().strip() == \
        os.path.realpath(out)
    assert (out / "linearham_run.trees").exists()


def _option_strings(mod, monkeypatch):
    """The option strings of ``mod.main``'s parser (parsing stops there)."""
    class Parsed(Exception):
        pass

    def capture(parser, *args, **kwargs):
        raise Parsed(parser)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(Parsed) as got:
        mod.main([])
    monkeypatch.undo()
    parser = got.value.args[0]
    return {s for a in parser._actions for s in a.option_strings}


def test_workflow_mains_take_the_same_options(monkeypatch):
    port = _option_strings(wf, monkeypatch)
    ref = _option_strings(jax_wf, monkeypatch)
    assert port - ref == {"--device"}
    assert ref - port == set()
    assert {"--rng-seed", "--template-path", "--no-nestly-subdirs",
            "--cluster-indices", "--asr-pfilters"} <= port


def test_template_rendering_matches_jax(tmp_path):
    from linearham_tpu.postprocess.revbayes_config import \
        generate_rev_file as jax_generate_rev_file
    from linearham_tpu_torch.postprocess.revbayes_config import \
        generate_rev_file

    template = tmp_path / "custom.rev"
    template.write_text(
        'seed({{ seed }})\ndata = "{{ fasta_path }}"\n'
        "mcmc({{ mcmc_iter }}, {{ mcmc_thin }}, {{ tune_iter }}, "
        "{{ tune_thin }})\nrates({{num_rates}})\n"
        'out = "{{ output_base }}.trees"\n')
    out = tmp_path / "run.rev"    # one output path: its base is rendered
    written = {}
    for name, fn in (("jax", jax_generate_rev_file),
                     ("port", generate_rev_file)):
        fn("seqs.fasta", str(out), 100, 2, 50, 5, 4, 7,
           template_path=str(template))
        written[name] = out.read_bytes()
    assert written["port"] == written["jax"]
    assert written["port"].decode() == (
        'seed(7)\ndata = "seqs.fasta"\nmcmc(100, 2, 50, 5)\nrates(4)\n'
        f'out = "{tmp_path / "run"}.trees"\n')

    bad = tmp_path / "bad.rev"
    bad.write_text("{{ not_a_var }}")
    for fn in (jax_generate_rev_file, generate_rev_file):
        with pytest.raises(KeyError, match="not_a_var"):
            fn("s.fa", str(tmp_path / "x.rev"), 1, 1, 1, 1, 1, 1,
               template_path=str(bad))
