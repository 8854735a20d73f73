"""AWS EC2 provisioner (parity: sky/provision/aws/)."""
