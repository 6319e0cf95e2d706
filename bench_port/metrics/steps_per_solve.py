"""steps_per_solve.<cell>: the mean of the steps each solve ran, as the
entry point reports them (``SolveResult.steps``): the solver's iterations
to a satisfied row, in whole chunks."""


def read(ctx):
    return sum(r.steps for r in ctx.records) / len(ctx.records)
