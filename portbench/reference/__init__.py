"""The plain reference: the collaborative model's arithmetic in float32
PyTorch tensor ops (``model.py``), its serving scores (``serve.py``) and
its first training steps with AdamW (``train.py``), from the
configuration file's sizes and the benchmark's seeded weights.

It imports nothing of the program and takes nothing the program made:
it draws every weight again from the seed (``portbench.weights``) and
reads the program's outputs only to judge them.  TF32 is off while it
runs.  ``prec="fp8"`` rounds every product's operands to float8 (e4m3,
scaled per row of activations and per column of weights): the control
that a comparison has to fail."""
