"""The plain references: frozen plain-PyTorch copies of the port's coupled
step, one package each (``wpmc_plain``; ``README.md`` lists its
differences).  A configuration names its own in its file's
``"reference"``; its builder (``benchmark/builders/<config>.py``)
assembles the reference's model and initial state from the seed with that
package's own code.  Nothing here imports the program."""
