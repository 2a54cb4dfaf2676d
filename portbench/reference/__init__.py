"""The plain reference of the benchmark: numpy only, nothing of the program.

``tables.ladder_spec`` works the ladder's OffsetLikely tables and tier
parameters out again from the configuration and the error profile;
``ladder.solve_ladder`` solves windows on them; ``check`` compares the
program's rows with the reference's.
"""
