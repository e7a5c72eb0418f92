from repro_torch.serve.cli import main

main()
