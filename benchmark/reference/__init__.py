"""The plain reference: ``wpmc_plain``, a frozen plain-PyTorch copy of the
port's coupled step (``README.md`` lists every difference).  Each
configuration's builder (``benchmark/builders/<config>.py``) assembles the
reference's model and initial state from the seed with this package's own
code.  Nothing here imports the program."""
