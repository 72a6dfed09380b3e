"""Host-side support shared by the port's layers."""
