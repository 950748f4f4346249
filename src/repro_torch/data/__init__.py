"""The synthetic token stream of the train path (numpy, host)."""
