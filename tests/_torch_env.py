"""Settings shared by the port's server tests (tests/test_torch_*.py).

INCIDENT_DIR: the incident plane is on by default on both servers, so an
SLO page or a straggler streak on a loaded CPU writes a bundle. The servers
the tests build write theirs to a temporary directory of this test process
(one per xdist worker, so no two workers' ``incident-<n>.json`` collide),
never under the working directory; it is removed when the process exits.
"""

import atexit
import shutil
import tempfile

INCIDENT_DIR = tempfile.mkdtemp(prefix="gofr-torch-incidents-")
atexit.register(shutil.rmtree, INCIDENT_DIR, ignore_errors=True)
