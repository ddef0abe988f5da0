"""Host helpers of the port."""
