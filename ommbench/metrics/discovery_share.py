"""Share of the two-phase engine's batches that ran the discovery path
(no caps entry, or an overflow rerun), of all its batches, in %."""
SOURCE = "program_counter"


def read(run):
    c = run["counts"]
    batches = c["spec"] + c["discovery"] - c["spec_overflow"]
    return 100.0 * c["discovery"] / batches if batches else None
