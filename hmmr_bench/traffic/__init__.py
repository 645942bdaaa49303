"""Traffic: ``<kind>.py`` drives the program; ``<mix>.json`` names a kind
and holds its parameters."""
