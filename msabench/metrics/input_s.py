"""input_s (s, program span): msa.phase_times["input"] per alignment,
the program's span "input" (kalign_tpu_torch/api.py, engine.py): the
arguments' checks, the Msa's construction, the input checks,
dealigning, sorting, the encodings, the anchors, the engine, the
autoroute and the scoring parameters. In a traced run it is the
program's host range layer.input, which names the idle gaps under it."""

from msabench import readers


def read(run):
    return readers.phase_mean(run, "input")
