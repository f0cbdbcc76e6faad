"""Model-selection helpers: the stratified folds calibration uses."""
