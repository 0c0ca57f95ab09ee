"""Distribution helpers of the port (scenario packing so far)."""
