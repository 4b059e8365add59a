"""The motion viewer (standalone HTML export, matplotlib stills) and the
interactive studio, on the port's device."""
