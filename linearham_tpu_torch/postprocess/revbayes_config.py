"""RevBayes MCMC configuration generation.

Renders the tree-inference Rev script for one clonal family: GTR with
Dirichlet priors on pi/er, Exp(1) on the gamma shape, uniform unrooted
topology with the naive sequence as outgroup, Exp(100) branch lengths, and
dnPhyloCTMC with ambiguous bases treated as gaps -- the same model the
reference templates (templates/revbayes_template.rev, rendered by
scripts/generate_revbayes_rev_file.py).
"""

from __future__ import annotations

import os

_TEMPLATE = """\
seed({seed})

# read in clonal family sequence data
data = readDiscreteCharacterData("{fasta_path}")
if (type(data) == "NULL") quit()

num_taxa <- data.ntaxa()
num_branches <- 2 * num_taxa - 3
taxa <- data.taxa()

mvi = 1
mni = 1

# GTR substitution model
pi_prior <- v(1,1,1,1)
pi ~ dnDirichlet(pi_prior)
moves[mvi++] = mvBetaSimplex(pi, weight=2.0)
moves[mvi++] = mvDirichletSimplex(pi, weight=1.0)

er_prior <- v(1,1,1,1,1,1)
er ~ dnDirichlet(er_prior)
moves[mvi++] = mvBetaSimplex(er, weight=3.0)
moves[mvi++] = mvDirichletSimplex(er, weight=1.5)

Q := fnGTR(er, pi)

# among-site rate variation
alpha ~ dnExponential(1)
moves[mvi++] = mvScaleBactrian(alpha, weight=2.0)
sr := fnDiscretizeGamma(alpha, alpha, {num_rates}, median=false)

# unrooted topology with the naive outgroup
out_group = clade("naive")
topology ~ dnUniformTopology(taxa, outgroup=out_group, rooted=false)
moves[mvi++] = mvNNI(topology, weight=num_taxa/2.0)
moves[mvi++] = mvSPR(topology, weight=num_taxa/10.0)

for (i in 1:num_branches) {{
    bl[i] ~ dnExponential(100.0)
    moves[mvi++] = mvScaleBactrian(bl[i], weight=1.0)
}}

TL := sum(bl)
tree := treeAssembly(topology, bl)

seq ~ dnPhyloCTMC(tree=tree, Q=Q, siteRates=sr, type="DNA",
                  treatAmbiguousAsGap=true)
seq.clamp(data)

mymodel = model(tree)

file_printgen = {mcmc_thin}
screen_printgen = 10 * file_printgen
monitors[mni++] = mnModel(filename="{output_base}.log",
                          printgen=file_printgen, separator="\\t")
monitors[mni++] = mnFile(pi, er, alpha, tree,
                         filename="{output_base}.trees",
                         printgen=file_printgen, separator="\\t",
                         posterior=false)
monitors[mni++] = mnScreen(TL, printgen=screen_printgen)

mymcmc = mcmc(mymodel, monitors, moves, nruns=1)
mymcmc.burnin(generations={tune_iter}, tuningInterval={tune_thin})
mymcmc.run(generations={mcmc_iter}, tuningInterval=0)
mymcmc.operatorSummary()

quit()
"""


def generate_rev_file(
    fasta_path: str,
    output_path: str,
    mcmc_iter: int,
    mcmc_thin: int,
    tune_iter: int,
    tune_thin: int,
    num_rates: int,
    seed: int,
    template_path: str = None,
) -> str:
    """Render the Rev MCMC config.

    With ``template_path`` a user-supplied Rev template is rendered by
    substituting its ``{{ var }}`` fields with the same variables the
    reference passes to jinja2 (scripts/generate_revbayes_rev_file.py:
    42-52, the reference's --template-path); otherwise the embedded model
    spec is used.
    """
    fields = dict(
        fasta_path=fasta_path,
        mcmc_iter=mcmc_iter,
        mcmc_thin=mcmc_thin,
        tune_iter=tune_iter,
        tune_thin=tune_thin,
        num_rates=num_rates,
        seed=seed,
        output_base=os.path.splitext(output_path)[0],
    )
    if template_path is None:
        text = _TEMPLATE.format(**fields)
    else:
        import re

        with open(template_path) as fh:
            raw = fh.read()

        def sub(m):
            name = m.group(1)
            if name not in fields:
                raise KeyError(
                    f"template variable {{{{ {name} }}}} is not one of "
                    f"{sorted(fields)}")
            return str(fields[name])

        text = re.sub(r"\{\{\s*(\w+)\s*\}\}", sub, raw)
    with open(output_path, "w") as fh:
        fh.write(text)
    return text
