"""An embedded cluster over real TCP (counterpart of pinot_tpu/cluster):
port servers behind port brokers and the brokers' HTTP edge."""
