"""One driver per entry family of the program, found by the name in the
cell's file (``workloads/<cell>.json``, ``driver``).

A driver's ``Driver(sizes, traffic, seed, device)`` makes the inputs and
warms the entry up (set-up); ``step()`` runs one unit of work through
the entry and returns its record (outputs kept for the check, stage
walls); ``end_to_end(records, window_s)`` gives the cell's end-to-end
metrics; ``release()`` frees the program's state; ``compare(records,
prec)`` runs the plain reference at ``prec`` and returns each unit's
numbers (see :mod:`benchmark.check`)."""
