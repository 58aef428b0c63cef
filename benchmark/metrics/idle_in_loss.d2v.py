"""Device idle while the d2v step issued its loss and gradient (the encoder's
forward and backward), in % of the traced stretch: the idle gaps inside the
program's ``d2v_pretrain.loss`` spans.

Read from the port's span recorder over the device trace's idle gaps
(``benchmark/lib/program_spans.py``); None where there is nothing to read."""

from benchmark.lib.program_spans import idle_inside


def read(ctx):
    return idle_inside(ctx, ("d2v_pretrain.loss",))
