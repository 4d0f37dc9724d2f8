from tpu_joints_torch.cli.main import main

main()
