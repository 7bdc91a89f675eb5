"""int8 serving: PTQ calibration, the export, the int8 forward, the predictor."""
