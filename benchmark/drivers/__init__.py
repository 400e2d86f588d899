"""One module per kind of cell (``train``, ``infer``), named by a cell
file's ``driver``; ``run(cell, config, seed, seconds, trace, device)``."""
