"""Host-side helpers of the apps."""
