"""output_s (s, program span): msa.phase_times["output"] per alignment,
the program's span "output" (kalign_tpu_torch/engine.py: finalise and
the input order restored). In a traced run it is the program's host
range layer.output."""

from msabench import readers


def read(run):
    return readers.phase_mean(run, "output")
