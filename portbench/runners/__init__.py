"""One module per kind of traffic, named by a mix's ``runner`` key; each
has ``run(ctx) -> dict`` (see ``portbench/run.py``)."""
