"""Seeded traffic: the batches a cell feeds the program, from the parameters
of its cell file (``benchmark/cells/<cell>.json``, key ``traffic``).

``images.make_pool`` makes device-resident batches; ``tree.write_tree``
writes a JPEG tree that the program's own loader reads. Each run's seed
changes what is drawn inside a fixed structure (which batches fill which
canvas, the photo sizes, the resize choices and the box counts are the
same set for every seed, in an order the seed picks), so seeds do not
change how much work a run does."""
