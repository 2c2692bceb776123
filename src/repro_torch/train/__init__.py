"""Training state and the MG-WFBP train step."""
