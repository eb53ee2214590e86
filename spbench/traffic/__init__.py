"""Traffic: each mix is a JSON file of parameters (``<mix>.json``) naming
the kind of loop that runs it (``<kind>.py``)."""
