"""setup_s: seconds from the start of the process to the first timed call
(imports, kernel libraries loaded or built, weights drawn, the edit
solved, the cell's shapes warmed). Host clock."""


def read(ctx):
    return ctx["setup_s"]
