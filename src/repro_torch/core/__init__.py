"""The detection pipeline: simulator, recorder, detection, MCG, FailRank
and the ``Sloth`` driver (numpy on the host, torch on ``device``)."""
